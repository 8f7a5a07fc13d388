// Online-softmax attention forward with GQA (the LM prefill's attention):
//
//     o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / G])
//                  * v[b, j, h / G]
//
// over keys j < sk (and j <= i when causal: the mask is top-left aligned,
// k_pos <= q_pos), q [B, Sq, H, D], k/v [B, Sk, KH, D], G = H / KH, in
// float32 or bf16, D <= 128.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:
// flash_attention_fwd (and, on the model path, the pure-JAX _flash forward
// of repro/models/common.py, which computes the same function). The TPU
// kernel carries (acc, m, l) in VMEM scratch across a sequential kv-block
// grid axis; here one CUDA block owns one (batch, head, 64-row q tile) and
// walks the kv tiles in a loop, so nothing crosses blocks: no atomics, each
// output written once, two calls bitwise equal.
//
// Numerics follow the reference exactly in kind: scores are float32 sums
// of the products of the working type, multiplied by the scale after the
// sum; the running max, sum and accumulator are float32; P is rounded to
// v's type before the PV product (the running sum takes the unrounded P);
// rows whose keys are all masked keep m = -inf, and both exp factors are
// guarded by isfinite as in the reference, so no NaN appears; the output is
// acc / max(l, 1e-20) rounded to q's type.
//
// Bound: at the LM's prefill shape (4 x 4,096 tokens, 12 heads on 2, D =
// 128, causal) one call is ~206 GFLOP against ~117 MB of q, k, v and o, so
// it is bound by operations (~0.21 ms at the bf16 dense tensor-core peak).
//
// Two kernels. bf16 with D = 64 or 128 (the LM path) runs on the tensor
// cores (flash_fwd_mma_kernel, below): mma.sync bf16 products summed in
// float32, Q in registers, K/V tiles double-buffered with cp.async, P kept
// in registers. Every other case (float32, other head dims) runs the SIMT
// float32 kernel (flash_fwd_kernel): 256 threads per block; the q tile is
// staged transposed in shared memory once, each kv tile's K (transposed)
// and then V share one buffer; S = Q K^T is a 4 x 4 register tile per
// thread read with float4 loads; the scaled, masked scores go to shared
// memory transposed ([key][row]), the online-softmax update runs four
// threads per row, and O = P V is a 4 x (D / 16) register tile per thread;
// it cannot go below ~3.1 ms at the prefill shape (the float32 vector
// peak). wgmma with TMA staging and warp specialisation is later speed
// work. In both, causal blocks stop at their last visible kv tile, and the
// grid issues the longest (last) q tiles first. Ragged Sq and Sk need no
// padded copies: rows at or beyond Sq load zeros and are not stored, keys
// at or beyond Sk load zeros and are masked.
#include "common.cuh"

#include <cuda_bf16.h>
#include <math.h>

// Internal linkage without an anonymous namespace, so the kernel keeps a
// plain mangled name in nvcc's -Xptxas -v report.
constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int LD = 68;          // padded leading dimension of transposed tiles
constexpr int THREADS = 256;

static __device__ __forceinline__ float to_f32(float x) { return x; }
static __device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> static __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back (P.astype(v.dtype) of the reference)
template <typename T> static __device__ __forceinline__ float round_to(
    float x) {
  return to_f32(from_f32<T>(x));
}

// rows x DM tile of a [.., row stride ld] array into dst[c * LD + r]
// (transposed), zero beyond n_rows valid rows and beyond d columns. A warp
// covers 2 rows x 16 consecutive columns: coalesced reads, at most 2-way
// bank conflicts on the transposed stores.
template <typename T, int DM, int ROWS>
static __device__ __forceinline__ void load_transposed(
    float* dst, const T* src, long long ld, int n_rows, int d) {
  constexpr int NC16 = DM / 16;
  for (int e = threadIdx.x; e < ROWS * DM; e += THREADS) {
    const int lane = e & 31, w = e >> 5;
    const int r = 2 * (w / NC16) + (lane >> 4);
    const int c = 16 * (w % NC16) + (lane & 15);
    float x = 0.f;
    if (r < n_rows && c < d) x = to_f32(src[r * ld + c]);
    dst[c * LD + r] = x;
  }
}

template <typename T, int DM>
static __global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int n_bh,
                 int sq, int sk, int h, int kh, int d, int n_qtiles,
                 float scale, int causal) {
  constexpr int NJ = DM / 16;             // output dims per thread
  constexpr int VEC = NJ < 4 ? NJ : 4;    // contiguous dims per group
  constexpr int NG = NJ / VEC;            // groups of VEC dims
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DM][LD]  q tile^T
  float* kv = qt + DM * LD;                     // [DM][LD] k^T, or [BK][DM] v
  float* pt = kv + DM * LD;                     // [BK][LD]  S^T, then P^T
  float* red_m = pt + BK * LD;                  // [4][BQ] partial row max
  float* red_s = red_m + 4 * BQ;                // [4][BQ] partial row sum
  float* row_alpha = red_s + 4 * BQ;            // [BQ]
  float* row_l = row_alpha + BQ;                // [BQ]

  const int tid = threadIdx.x;
  const int qtile = n_qtiles - 1 - static_cast<int>(blockIdx.x / n_bh);
  const int bh = static_cast<int>(blockIdx.x % n_bh);
  const int b = bh / h, hh = bh % h;
  const int kvh = hh / (h / kh);
  const int q0 = qtile * BQ;
  const long long q_ld = static_cast<long long>(h) * d;
  const long long kv_ld = static_cast<long long>(kh) * d;
  const T* qb = q + (static_cast<long long>(b) * sq * h + hh) * d;
  const T* kb = k + (static_cast<long long>(b) * sk * kh + kvh) * d;
  const T* vb = v + (static_cast<long long>(b) * sk * kh + kvh) * d;

  // S / PV micro-tile owner: rows tr*4 .. tr*4+3
  const int tr = tid >> 4, tc = tid & 15;
  // softmax owner: one row, a quarter of the tile's keys
  const int srow = tid & (BQ - 1), spart = tid >> 6;

  load_transposed<T, DM, BQ>(qt, qb + q0 * q_ld, q_ld, sq - q0, d);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  float m_run = -INFINITY;     // every softmax thread of a row holds it
  float l_run = 0.f;           // summed by spart == 0 only

  const int kv_end = causal ? min(sk, q0 + BQ) : sk;
  const int n_kt = (kv_end + BK - 1) / BK;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BK;
    const int n_keys = min(BK, sk - k0);
    __syncthreads();                 // the previous tile's PV is done
    load_transposed<T, DM, BK>(kv, kb + k0 * kv_ld, kv_ld, n_keys, d);
    __syncthreads();

    // S = Q K^T on a 4 x 4 register tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DM; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + c * LD + tr * 4);
      const float4 ka = *reinterpret_cast<const float4*>(kv + c * LD + tc * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kvv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kvv[j], s[i][j]);
    }
    // scale after the sum, mask, store transposed
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kp = k0 + tc * 4 + j;
      float out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = q0 + tr * 4 + i;
        const bool visible = kp < sk && (!causal || kp <= qp);
        out[i] = visible ? s[i][j] * scale : -INFINITY;
      }
      *reinterpret_cast<float4*>(pt + (tc * 4 + j) * LD + tr * 4) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
    __syncthreads();                 // S written, K no longer read

    // V replaces K in the shared buffer, row-major [BK][DM]
    for (int e = tid; e < BK * DM; e += THREADS) {
      const int r = e / DM, c = e % DM;
      kv[e] = (r < n_keys && c < d) ? to_f32(vb[(k0 + r) * kv_ld + c]) : 0.f;
    }
    // online softmax, part 1: the row max over this tile
    float sv[16];
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      sv[u] = pt[(spart * 16 + u) * LD + srow];
      mx = fmaxf(mx, sv[u]);
    }
    red_m[spart * BQ + srow] = mx;
    __syncthreads();
    // part 2: P, its partial sums and the rescale factor
    float m_new = m_run;
#pragma unroll
    for (int u = 0; u < 4; ++u) m_new = fmaxf(m_new, red_m[u * BQ + srow]);
    const bool finite_new = isfinite(m_new);
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const float p = finite_new ? expf(sv[u] - m_new) : 0.f;
      psum += p;
      pt[(spart * 16 + u) * LD + srow] = round_to<T>(p);
    }
    const float alpha = isfinite(m_run) ? expf(m_run - m_new) : 0.f;
    m_run = m_new;
    red_s[spart * BQ + srow] = psum;
    if (spart == 0) row_alpha[srow] = alpha;
    __syncthreads();                 // P, V, the sums and alpha are in place
    if (spart == 0)
      l_run = l_run * alpha + ((red_s[srow] + red_s[BQ + srow])
                               + (red_s[2 * BQ + srow] + red_s[3 * BQ + srow]));

    // O = O * alpha + P V on a 4 x NJ register tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_alpha[tr * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= a;
    }
    const int kn = min(BK, kv_end - k0);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + kk * LD + tr * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      float vv[NJ];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float* src = kv + kk * DM + g * 16 * VEC + tc * VEC;
        if constexpr (VEC == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          vv[g * 4] = x.x; vv[g * 4 + 1] = x.y;
          vv[g * 4 + 2] = x.z; vv[g * 4 + 3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(src);
          vv[g * 2] = x.x; vv[g * 2 + 1] = x.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  if (spart == 0) row_l[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    if (q0 + r >= sq) continue;
    const float inv_l = 1.f / fmaxf(row_l[r], 1e-20f);
    T* dst = o + (static_cast<long long>(b) * sq + q0 + r) * q_ld
             + static_cast<long long>(hh) * d;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int c = g * 16 * VEC + tc * VEC + j;
        if (c < d) dst[c] = from_f32<T>(acc[i][g * VEC + j] * inv_l);
      }
  }
}

static constexpr size_t smem_bytes(int dm) {
  return sizeof(float) * (2 * dm * LD + BK * LD + 4 * BQ * 2 + 2 * BQ);
}

template <typename T, int DM>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int b, int sq, int sk, int h, int kh, int d, float scale,
                  int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(DM);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bh = b * h;
  const int n_qtiles = (sq + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(n_bh) * n_qtiles;
  flash_fwd_kernel<T, DM><<<static_cast<unsigned>(blocks), THREADS, smem,
                            stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n_bh, sq, sk, h, kh, d,
      n_qtiles, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_d(const void* q, const void* k, const void* v, void* o,
                    int b, int sq, int sk, int h, int kh, int d, float scale,
                    int causal, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, b, sq, sk, h, kh, d, scale, causal,
                         stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, b, sq, sk, h, kh, d, scale, causal,
                         stream);
  return launch<T, 128>(q, k, v, o, b, sq, sk, h, kh, d, scale, causal,
                        stream);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (D = 64 or 128): the same function, with QK^T
// and PV as mma.sync.m16n8k16 bf16 products summed in float32. Four warps
// own 16 q rows each of a 64-row tile; Q stays in registers as A fragments,
// K and V tiles of 64 keys stream through two shared-memory buffers
// (cp.async, the next tile in flight while this one is multiplied, rows
// padded by 16 bytes so ldmatrix reads no bank twice). The scores come out
// of the products in registers in the layout the PV product takes as its
// A operand, so P never touches shared memory: it is rounded to bf16 there
// (the reference's P.astype(v.dtype)), while the running sum takes the
// unrounded P. Each thread keeps the running max of its two rows (reduced
// over its quad every tile) and a partial sum, reduced once at the end.
// ---------------------------------------------------------------------------

static __device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

static __device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                                   const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

static __device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                         const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 sums
static __device__ __forceinline__ void mma_bf16(float (&c)[4],
                                                const unsigned (&a)[4],
                                                unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static __device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// ROWS x D bf16 rows (row stride ld elements) into dst[r * (D + 8) + c]
// with cp.async, 16 bytes a copy; rows at or beyond n_rows are zero-filled
// (no bytes read).
template <int D, int ROWS, int NT>
static __device__ __forceinline__ void load_rows_async(
    __nv_bfloat16* dst, const __nv_bfloat16* src, long long ld, int n_rows) {
  constexpr int CHUNKS = D / 8;
  for (int e = threadIdx.x; e < ROWS * CHUNKS; e += NT) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
    const bool in = r < n_rows;
    const __nv_bfloat16* g = in ? src + r * ld + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst + r * (D + 8) + c)), "l"(g),
                    "r"(in ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int D>
static __global__ void __launch_bounds__(128, 2)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int n_bh, int sq, int sk,
                     int h, int kh, int n_qtiles, float scale, int causal) {
  constexpr int NT = 128, LDS = D + 8, KS = D / 16, DT = D / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sq_t = reinterpret_cast<__nv_bfloat16*>(smem4);  // [BQ][LDS]
  __nv_bfloat16* sk_t = sq_t + BQ * LDS;                      // [2][BK][LDS]
  __nv_bfloat16* sv_t = sk_t + 2 * BK * LDS;                  // [2][BK][LDS]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qtile = n_qtiles - 1 - static_cast<int>(blockIdx.x / n_bh);
  const int bh = static_cast<int>(blockIdx.x % n_bh);
  const int b = bh / h, hh = bh % h;
  const int kvh = hh / (h / kh);
  const int q0 = qtile * BQ;
  const long long q_ld = static_cast<long long>(h) * D;
  const long long kv_ld = static_cast<long long>(kh) * D;
  const __nv_bfloat16* qb = q + (static_cast<long long>(b) * sq * h + hh) * D;
  const __nv_bfloat16* kb =
      k + (static_cast<long long>(b) * sk * kh + kvh) * D;
  const __nv_bfloat16* vb =
      v + (static_cast<long long>(b) * sk * kh + kvh) * D;

  const int kv_end = causal ? min(sk, q0 + BQ) : sk;
  const int n_kt = (kv_end + BK - 1) / BK;
  load_rows_async<D, BQ, NT>(sq_t, qb + q0 * q_ld, q_ld, sq - q0);
  if (n_kt > 0) {
    load_rows_async<D, BK, NT>(sk_t, kb, kv_ld, min(BK, sk));
    load_rows_async<D, BK, NT>(sv_t, vb, kv_ld, min(BK, sk));
  }
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 q rows as A fragments, one per 16 dims
  unsigned qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qa[ks], sq_t + (warp * 16 + (lane & 15)) * LDS + ks * 16
                            + (lane >> 4) * 8);

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};      // this thread's columns only
  const int row0 = q0 + warp * 16 + (lane >> 2);

  for (int t = 0; t < n_kt; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_kt) {
      const int k1 = (t + 1) * BK;
      load_rows_async<D, BK, NT>(sk_t + (cur ^ 1) * BK * LDS, kb + k1 * kv_ld,
                                 kv_ld, min(BK, sk - k1));
      load_rows_async<D, BK, NT>(sv_t + (cur ^ 1) * BK * LDS, vb + k1 * kv_ld,
                                 kv_ld, min(BK, sk - k1));
    }
    const __nv_bfloat16* kt_s = sk_t + cur * BK * LDS;
    const __nv_bfloat16* vt_s = sv_t + cur * BK * LDS;
    const int k0 = t * BK;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        unsigned kf[4];
        const int mi = lane >> 3;
        ldmatrix_x4(kf, kt_s + (nt * 8 + (mi >> 1) * 8 + (lane & 7)) * LDS
                            + ks * 16 + (mi & 1) * 8);
        mma_bf16(s[nt], qa[ks], kf[0], kf[1]);
        mma_bf16(s[nt + 1], qa[ks], kf[2], kf[3]);
      }
    }

    // scale after the sum, mask, online softmax on rows row0 and row0 + 8
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qp = row0 + half * 8;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + nt * 8 + (lane & 3) * 2 + e;
          const bool visible = kp < sk && (!causal || kp <= qp);
          float& x = s[nt][half * 2 + e];
          x = visible ? x * scale : -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);
      const bool finite_new = isfinite(m_new);
      const float alpha = isfinite(m_run[half]) ? expf(m_run[half] - m_new)
                                                : 0.f;
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][half * 2 + e];
          x = finite_new ? expf(x - m_new) : 0.f;
          psum += x;
        }
      l_run[half] = l_run[half] * alpha + psum;
      m_run[half] = m_new;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][half * 2] *= alpha;
        acc[j][half * 2 + 1] *= alpha;
      }
    }

    // O += P V: P (rounded to bf16) from the score registers, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        unsigned vf[4];
        const int mi = lane >> 3;
        ldmatrix_x4_trans(vf, vt_s + (kk * 16 + (mi & 1) * 8 + (lane & 7))
                                         * LDS + dt * 8 + (mi >> 1) * 8);
        mma_bf16(acc[dt], pa, vf[0], vf[1]);
        mma_bf16(acc[dt + 1], pa, vf[2], vf[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();          // the next tile is in; this one is free
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_run[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qp = row0 + half * 8;
    if (qp >= sq) continue;
    const float inv_l = 1.f / fmaxf(l, 1e-20f);
    __nv_bfloat16* dst = o + (static_cast<long long>(b) * sq + qp) * q_ld
                         + static_cast<long long>(hh) * D + (lane & 3) * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
          __floats2bfloat162_rn(acc[dt][half * 2] * inv_l,
                                acc[dt][half * 2 + 1] * inv_l);
  }
}

template <int D>
static int launch_mma(const void* q, const void* k, const void* v, void* o,
                      int b, int sq, int sk, int h, int kh, float scale,
                      int causal, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (BQ + 4 * BK) * (D + 8);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bh = b * h;
  const int n_qtiles = (sq + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(n_bh) * n_qtiles;
  flash_fwd_mma_kernel<D><<<static_cast<unsigned>(blocks), 128, smem,
                            stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      n_bh, sq, sk, h, kh, n_qtiles, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16. The wrapper checks shapes (Sq >= 1,
// D <= 128, H a multiple of KH), types and contiguity.
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, void* o, int b, int sq,
                                        int sk, int h, int kh, int d,
                                        int dtype, int causal, float scale,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 128)
    return launch_mma<128>(q, k, v, o, b, sq, sk, h, kh, scale, causal, s);
  if (dtype == 1 && d == 64)
    return launch_mma<64>(q, k, v, o, b, sq, sk, h, kh, scale, causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, kh, d, scale,
                                   causal, s);
  return launch_d<float>(q, k, v, o, b, sq, sk, h, kh, d, scale, causal, s);
}
