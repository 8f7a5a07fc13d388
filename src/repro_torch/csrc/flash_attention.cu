// Online-softmax attention forward with GQA (the LM prefill's attention):
//
//     o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / G])
//                  * v[b, j, h / G]
//
// over keys j < sk (and j <= i when causal: the mask is top-left aligned,
// k_pos <= q_pos), q [B, Sq, H, D], k [B, Sk, KH, D], v [B, Sk, KH, DV],
// o [B, Sq, H, DV], G = H / KH, scale = 1 / sqrt(D), in float32 or bf16,
// D <= 192, DV <= 128 (MLA's prefill: D = 192 = 128 nope + 64 rope, DV =
// 128; the dense LMs: DV = D).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:
// flash_attention_fwd (and, on the model path, the pure-JAX _flash forward
// of repro/models/common.py, which computes the same function). The TPU
// kernel carries (acc, m, l) in VMEM scratch across a sequential kv-block
// grid axis; here each (batch, head, q tile) is owned by one CUDA block,
// which walks its kv tiles in a loop, so nothing crosses blocks: no
// atomics, each output written once, two calls bitwise equal.
//
// Numerics follow the reference exactly in kind: scores are float32 sums
// of the products of the working type, scaled after the sum; the running
// max, sum and accumulator are float32; P is rounded to v's type before
// the PV product (the running sum takes the unrounded P); rows whose keys
// are all masked keep m = -inf, and both exp factors are guarded by
// isfinite as in the reference, so no NaN appears; the output is
// acc / max(l, 1e-20) rounded to q's type. Given a non-null lse pointer,
// both kernels also write each row's log-sum-exp of the scaled scores,
// float32 [B, Sq, H] (the reference's [B, Sq, KH, G]: query head h sits on
// KV head h / G), m + ln max(l, 1e-30) and -inf where l = 0, as _flash_fwd
// returns it for the _flash_bwd recompute (one store per row; the output
// is the same with and without it).
//
// Bound: at the LM's prefill shape (4 x 4,096 tokens, 12 heads on 2, D =
// 128, causal) one call is ~206 GFLOP against ~117 MB of q, k, v and o, so
// it is bound by operations: ~0.21 ms at the bf16 dense tensor-core peak.
//
// Two kernels. bf16 with (D, DV) = (64, 64), (128, 128) or (192, 128) (the
// LM paths) runs flash_fwd_wgmma_kernel (below), built for Hopper's tensor
// cores:
// persistent CTAs of three warpgroups, one per SM, each walking 128-row q
// tiles. One producer warp, its registers given up with setmaxnreg, issues
// TMA loads: Q once per q tile, then K and V tiles of 128 keys into a ring
// of stages, each buffer with a "full" mbarrier armed with the bytes to
// expect and an "empty" one the consumers release. Two consumer warpgroups
// own 64 q rows each and take turns on the tensor cores: S = Q K^T by
// wgmma with both operands in shared memory, the online softmax in
// registers (exp2 with the scale folded into one FMA, the mask applied
// only on tiles that cross the diagonal or Sk) while the previous tile's
// O += P V runs, P packed to bf16 in registers as that product's A operand
// and V read MN-major from shared memory. Every other case (float32,
// other head dims) runs the SIMT float32 kernel
// (flash_fwd_kernel): 256 threads per block over a 64-row q tile; the q
// tile is staged transposed in shared memory once, each kv tile's K
// (transposed) and then V share one buffer; S = Q K^T is a 4 x 4 register
// tile per thread read with float4 loads; the scaled, masked scores go to
// shared memory transposed ([key][row]), the online-softmax update runs
// four threads per row, and O = P V is a 4 x (DV / 16) register tile per
// thread; it cannot go below ~3.1 ms at the prefill shape (the float32
// vector peak). It is built for a padded q/k width DM of 32, 64, 128 or
// 192 and a padded output width DVM <= DM of 32, 64 or 128 (DM = 192
// takes 124 KB of shared memory, one block an SM). In both, causal blocks stop at their last visible kv tile,
// and the grid issues the longest (last) q tiles first. Ragged Sq and Sk
// need no padded copies: rows at or beyond Sq load zeros and are not
// stored, keys at or beyond Sk load zeros and are masked.
#include "common.cuh"

#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

template <typename T, int DM, int DVM>
static __global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n_bh, int sq, int sk, int h,
                 int kh, int d, int dv, int n_qtiles, float scale,
                 int causal) {
  static_assert(DVM <= DM, "V's rows share the transposed K tile's buffer");
  constexpr int NJ = DVM / 16;            // output dims per thread
  constexpr int VEC = NJ < 4 ? NJ : 4;    // contiguous dims per group
  constexpr int NG = NJ / VEC;            // groups of VEC dims
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DM][LD]  q tile^T
  float* kv = qt + DM * LD;                     // [DM][LD] k^T, or [BK][DVM] v
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
  const long long v_ld = static_cast<long long>(kh) * dv;
  const long long o_ld = static_cast<long long>(h) * dv;
  const T* qb = q + (static_cast<long long>(b) * sq * h + hh) * d;
  const T* kb = k + (static_cast<long long>(b) * sk * kh + kvh) * d;
  const T* vb = v + (static_cast<long long>(b) * sk * kh + kvh) * dv;

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

    // V replaces K in the shared buffer, row-major [BK][DVM]
    for (int e = tid; e < BK * DVM; e += THREADS) {
      const int r = e / DVM, c = e % DVM;
      kv[e] = (r < n_keys && c < dv) ? to_f32(vb[(k0 + r) * v_ld + c]) : 0.f;
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
        const float* src = kv + kk * DVM + g * 16 * VEC + tc * VEC;
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
  // the log-sum-exp of the row's scaled scores, for the backward
  if (lse != nullptr && spart == 0 && q0 + srow < sq)
    lse[(static_cast<long long>(b) * sq + q0 + srow) * h + hh] =
        l_run > 0.f ? m_run + logf(fmaxf(l_run, 1e-30f)) : -INFINITY;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    if (q0 + r >= sq) continue;
    const float inv_l = 1.f / fmaxf(row_l[r], 1e-20f);
    T* dst = o + (static_cast<long long>(b) * sq + q0 + r) * o_ld
             + static_cast<long long>(hh) * dv;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int c = g * 16 * VEC + tc * VEC + j;
        if (c < dv) dst[c] = from_f32<T>(acc[i][g * VEC + j] * inv_l);
      }
  }
}

static constexpr size_t smem_bytes(int dm) {
  return sizeof(float) * (2 * dm * LD + BK * LD + 4 * BQ * 2 + 2 * BQ);
}

template <typename T, int DM, int DVM>
static int launch(const void* q, const void* k, const void* v, void* o,
                  float* lse, int b, int sq, int sk, int h, int kh, int d,
                  int dv, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(DM);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DM, DVM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bh = b * h;
  const int n_qtiles = (sq + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(n_bh) * n_qtiles;
  flash_fwd_kernel<T, DM, DVM><<<static_cast<unsigned>(blocks), THREADS,
                                 smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, n_bh, sq, sk, h, kh,
      d, dv, n_qtiles, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// The output width's instance for a padded q/k width DM >= dv
template <typename T, int DM>
static int launch_dv(const void* q, const void* k, const void* v, void* o,
                     float* lse, int b, int sq, int sk, int h, int kh, int d,
                     int dv, float scale, int causal, cudaStream_t stream) {
  if (dv <= 32)
    return launch<T, DM, 32>(q, k, v, o, lse, b, sq, sk, h, kh, d, dv, scale,
                             causal, stream);
  if constexpr (DM >= 64) {
    if (dv <= 64)
      return launch<T, DM, 64>(q, k, v, o, lse, b, sq, sk, h, kh, d, dv,
                               scale, causal, stream);
  }
  if constexpr (DM >= 128)
    return launch<T, DM, 128>(q, k, v, o, lse, b, sq, sk, h, kh, d, dv,
                              scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
static int launch_d(const void* q, const void* k, const void* v, void* o,
                    float* lse, int b, int sq, int sk, int h, int kh, int d,
                    int dv, float scale, int causal, cudaStream_t stream) {
  const int dm = d > dv ? d : dv;
  if (dm <= 32)
    return launch_dv<T, 32>(q, k, v, o, lse, b, sq, sk, h, kh, d, dv, scale,
                            causal, stream);
  if (dm <= 64)
    return launch_dv<T, 64>(q, k, v, o, lse, b, sq, sk, h, kh, d, dv, scale,
                            causal, stream);
  if (dm <= 128)
    return launch_dv<T, 128>(q, k, v, o, lse, b, sq, sk, h, kh, d, dv, scale,
                             causal, stream);
  return launch_dv<T, 192>(q, k, v, o, lse, b, sq, sk, h, kh, d, dv, scale,
                           causal, stream);
}

// ---------------------------------------------------------------------------
// bf16 with (D, DV) = (64, 64), (128, 128) or (192, 128) on Hopper:
// flash_fwd_wgmma_kernel.
//
// Persistent CTAs, one per SM, each walking work tiles (a 128-row q tile of
// one (batch, head)) longest first, in rounds of the grid taken forwards
// and backwards in turn (snake_tile), so the next tile's loads overlap the
// last one's tail and no CTA is left with much more work than another.
//
// A CTA is 384 threads. Warpgroup 0 is the producer: it drops to 40
// registers (setmaxnreg) and one lane issues every TMA load, Q once per
// work tile and K and V per kv tile into a ring of stages; every buffer
// has a "full" mbarrier, armed with the bytes to expect, and an "empty"
// one that the consumers' eight warps arrive on when they are done with
// it (K after S = Q K^T, V after O += P V, Q after its tile's last S).
// Warpgroups 1 and 2 are the consumers, 64 q rows each (wgmma's M), at
// 232 registers. Shared memory, every tile 1024-byte aligned and 128-byte
// swizzled by TMA exactly as wgmma's SWIZZLE_128B descriptors read it: Q
// [128 rows][D] as D / 64 panels of 128 rows x 128 bytes (32 KB at D =
// 128), then STAGES K tiles (D / 64 panels) and STAGES V tiles (DV / 64
// panels) of 128 keys in the same panel form, then the barriers: 160 KB at
// D = 128 (two stages), 144 KB at D = 64 (four stages), 208 KB at (192,
// 128) (two stages: Q 48 KB, K 2 x 48, V 2 x 32).
//
// The products, per consumer warpgroup and kv tile:
//   S = Q K^T   wgmma m64n128k16, both operands K-major in shared memory,
//               D / 16 k-steps: a k-step of 16 dims advances 32 bytes
//               inside a 64-dim panel and jumps a panel at 64 (SBO = 1024:
//               eight rows);
//   O += P V    wgmma m64nDVk16 with P from registers (the score
//               accumulator's layout is the A fragment's, so P never
//               touches shared memory) and V MN-major (the transpose bit):
//               a k-step of 16 keys advances 2,048 bytes, LBO is the
//               stride to the next 64-dim panel, SBO eight keys.
// The two consumer groups take turns on the tensor cores (named barriers
// 1 and 2): in its turn a group issues kv tile t's S and kv tile t-1's
// O += P V and hands the turn over; it then runs tile t's softmax while
// its own P V and the other group's products run.
// ---------------------------------------------------------------------------

constexpr int WG_BQ = 128;          // q rows per CTA
constexpr int WG_BK = 128;          // keys per kv tile
constexpr int WG_THREADS = 384;     // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 40 + 2 x 232 = 3 x 168 (launch bound)
constexpr float LOG2E = 1.4426950408889634f;

constexpr int Q_PANEL = WG_BQ * 128;    // bytes of one Q panel
constexpr int KV_PANEL = WG_BK * 128;   // bytes of one K/V panel

template <int D, int DV> struct WgTile {
  static constexpr int PANELS = D / 64;          // 128-byte panels of Q, K
  static constexpr int V_PANELS = DV / 64;       // and of V
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int K_BYTES = PANELS * KV_PANEL;
  static constexpr int V_BYTES = V_PANELS * KV_PANEL;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * K_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * V_BYTES;
  // full and empty barriers for Q, then for K and for V per stage; 1 KB
  // of slack to align the dynamic shared memory's base to 1,024 bytes
  static constexpr int SMEM = OFF_BAR + 8 * (2 + 4 * STAGES) + 1024;
  static_assert(SMEM <= 232448, "over the 227 KB of shared memory a block "
                                "may take");
};

static __device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

static __device__ __forceinline__ void mbar_init(uint32_t bar,
                                                 uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. (No
// trap on a long wait: a __trap anywhere in the kernel keeps ptxas from
// giving the consumers the registers setmaxnreg asks for.)
static __device__ __forceinline__ void mbar_wait(uint32_t bar,
                                                 uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box of a 4-D tensor map into shared memory, completing on `bar`
static __device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int c0,
                                                   int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (layout type
// 1): start address, leading and stride byte offsets, in 16-byte units.
// Every tile is 1024-byte aligned, so the base offset is 0.
static __device__ __forceinline__ uint64_t sw128_desc(uint32_t addr,
                                                      uint32_t lbo,
                                                      uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}

static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight (groups
// complete in order).
template <int N>
static __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from touching wgmma's registers across its issue and
// wait: the accumulators are read only after this point.
template <int N>
static __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
static __device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

static __device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128, float32) += a (64 x 16) * b (16 x 128), bf16, both from
// shared memory through descriptors, both K-major
static __device__ __forceinline__ void wgmma_ss_n128(float (&d)[64],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 128, float32) = a (64 x 16) * b (16 x 128): the first k-step,
// which ignores d's old value (scale-d false), so d is output-only here and
// the compiler need not keep its old contents alive up to this point
static __device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64],
                                                         uint64_t da,
                                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
      "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
      "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
      "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
      "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
      "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
      "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
      "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
      "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
      "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
      "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
      "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
      "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
      "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
      "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
      "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0)
      : "memory");
}

// d (64 x 128, float32) += a (64 x 16, bf16 pairs in registers, the
// m16n8k16 A-fragment layout per warp) * b (16 x 128, bf16, shared memory,
// MN-major: the transpose bit)
static __device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 64, float32) += a (64 x 16, bf16 pairs in registers, the
// m16n8k16 A-fragment layout per warp) * b (16 x 64, bf16, shared memory,
// MN-major: the transpose bit)
static __device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// S = Q K^T for one kv tile (issued, not waited on): 64 q rows x 128 keys,
// D / 16 k-steps
template <int D>
static __device__ __forceinline__ void qk_product(float (&s)[64],
                                                  uint32_t q_wg,
                                                  uint32_t k_tile) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t qoff = (ks >> 2) * Q_PANEL + (ks & 3) * 32;
    const uint32_t koff = (ks >> 2) * KV_PANEL + (ks & 3) * 32;
    const uint64_t da = sw128_desc(q_wg + qoff, 16, 1024);
    const uint64_t db = sw128_desc(k_tile + koff, 16, 1024);
    if (ks == 0) wgmma_ss_n128_first(s, da, db);
    else wgmma_ss_n128(s, da, db);
  }
}

// O += P V for one kv tile (issued, not waited on): 128 keys in 8 k-steps
// of 16, P's registers p[4 kk .. 4 kk + 3] for keys 16 kk .. 16 kk + 15
template <int DV>
static __device__ __forceinline__ void pv_product(float (&acc)[DV / 2],
                                                  const uint32_t (&p)[32],
                                                  uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < WG_BK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    const uint64_t db = sw128_desc(v_tile + kk * 16 * 128, KV_PANEL, 1024);
    if constexpr (DV == 128) wgmma_rs_n128(acc, a, db);
    else wgmma_rs_n64(acc, a, db);
  }
}

// The online softmax over one tile's scores s[4 j + e] (row row0 + 8 (e >>
// 1), key k0 + 8 j + 2 (lane & 3) + (e & 1)): masks where `edge` (the tile
// crosses Sk or the diagonal), takes the row max over the quad on the raw
// scores, and leaves P = exp2(s * scale_log2 - m * scale_log2) in s (one
// FMA and one exp2 each), the rescale factor of each row in alpha, and the
// running max and this thread's running sum updated.
static __device__ __forceinline__ void softmax_tile(
    float (&s)[64], float (&m_run)[2], float (&l_run)[2], float (&alpha)[2],
    bool edge, int k0, int row0, int lane, int sk, int causal,
    float scale_log2) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int kp = k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
      const int qp = row0 + ((i >> 1) & 1) * 8;
      if (kp >= sk || (causal && kp > qp)) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float m_use[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
    const float m_new = fmaxf(m_run[half], mx[half]);
    m_use[half] = isfinite(m_new) ? m_new * scale_log2 : 0.f;
    alpha[half] = isfinite(m_run[half])
                      ? ex2(fmaf(m_run[half], scale_log2, -m_use[half]))
                      : 0.f;
    m_run[half] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int half = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], scale_log2, -m_use[half]));
    psum[half] += s[i];
  }
#pragma unroll
  for (int half = 0; half < 2; ++half)
    l_run[half] = l_run[half] * alpha[half] + psum[half];
}

// O *= alpha, then P rounded to bf16 and packed as the A fragments
template <int DV>
static __device__ __forceinline__ void rescale_and_pack(
    float (&acc)[DV / 2], uint32_t (&p)[32], const float (&s)[64],
    const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// Named barriers 1 and 2 (0 is __syncthreads) between the two consumer
// warpgroups, 256 threads each: sync waits for the other group's arrive.
static __device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

static __device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

static __device__ __forceinline__ void warp_arrive(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// The work tiles, longest first: tile i is q tile n_qtiles - 1 - i / n_bh
// of (batch, head) i % n_bh.
struct WorkTile {
  int b, hh, q0;
};

static __device__ __forceinline__ WorkTile work_tile(int i, int n_bh, int h,
                                                     int n_qtiles) {
  const int bh = i % n_bh;
  return {bh / h, bh % h, (n_qtiles - 1 - i / n_bh) * WG_BQ};
}

// The kv tiles a q tile at q0 walks: causal ones stop at the diagonal.
static __device__ __forceinline__ int kv_tiles(int q0, int sk, int causal) {
  const int kv_end = causal ? min(sk, q0 + WG_BQ) : sk;
  return (kv_end + WG_BK - 1) / WG_BK;
}

// The r-th tile of CTA c among `grid` persistent CTAs: rounds of `grid`
// tiles, walked forwards and backwards in turn, so that with the tiles
// sorted longest first every CTA gets about the same work.
static __device__ __forceinline__ int snake_tile(int r, int c, int grid) {
  return r * grid + ((r & 1) ? grid - 1 - c : c);
}

template <int D, int DV>
static __global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                       __grid_constant__ const CUtensorMap tk,
                       __grid_constant__ const CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int n_bh, int sq, int sk,
                       int h, int kh, int n_qtiles, float scale,
                       float scale_log2, int causal) {
  using T = WgTile<D, DV>;
  constexpr int S = T::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_k = base + T::OFF_K;
  const uint32_t s_v = base + T::OFF_V;
  const uint32_t full_q = base + T::OFF_BAR;
  const uint32_t empty_q = full_q + 8;
  const uint32_t full_k = empty_q + 8;          // + 8 * stage, each
  const uint32_t full_v = full_k + 8 * S;
  const uint32_t empty_k = full_v + 8 * S;
  const uint32_t empty_v = empty_k + 8 * S;

  const int n_tiles = n_qtiles * n_bh;
  const int grid = static_cast<int>(gridDim.x);
  const int cta = static_cast<int>(blockIdx.x);
  const int group = h / kh;
  // warp-uniform by construction (a shuffle from lane 0)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                             0);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 8);              // the consumers' eight warps
    for (int st = 0; st < S; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty_k + 8 * st, 8);
      mbar_init(empty_v + 8 * st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one lane keeps Q and the K/V ring full, tile after
    // tile; the next tile's Q loads while the consumers finish this one
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int st = 0;
      uint32_t phase = 0;
      for (int r = 0;; ++r) {
        const int i = snake_tile(r, cta, grid);
        if (i >= n_tiles) break;
        const WorkTile w = work_tile(i, n_bh, h, n_qtiles);
        const int kvh = w.hh / group;
        mbar_wait(empty_q, (r & 1) ^ 1);          // round 0 passes at once
        mbar_expect_tx(full_q, T::Q_BYTES);
#pragma unroll
        for (int p = 0; p < T::PANELS; ++p)
          tma_load_4d(s_q + p * Q_PANEL, &tq, full_q, p * 64, w.hh, w.q0,
                      w.b);
        const int n_kt = kv_tiles(w.q0, sk, causal);
        for (int t = 0; t < n_kt; ++t) {
          const uint32_t kt = s_k + st * T::K_BYTES;
          const uint32_t vt = s_v + st * T::V_BYTES;
          mbar_wait(empty_k + 8 * st, phase ^ 1);
          mbar_expect_tx(full_k + 8 * st, T::K_BYTES);
#pragma unroll
          for (int p = 0; p < T::PANELS; ++p)
            tma_load_4d(kt + p * KV_PANEL, &tk, full_k + 8 * st, p * 64,
                        kvh, t * WG_BK, w.b);
          mbar_wait(empty_v + 8 * st, phase ^ 1);
          mbar_expect_tx(full_v + 8 * st, T::V_BYTES);
#pragma unroll
          for (int p = 0; p < T::V_PANELS; ++p)
            tma_load_4d(vt + p * KV_PANEL, &tv, full_v + 8 * st, p * 64,
                        kvh, t * WG_BK, w.b);
          if (++st == S) { st = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows per warpgroup. The two groups take turns
    // on the tensor cores (named barriers 1 and 2, group 0 first): in its
    // turn a group issues kv tile t's S = Q K^T and kv tile t-1's O += P V,
    // hands the turn over, and runs tile t's softmax while its own P V and
    // the other group's products run. Turns run on across work tiles.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    const int cw = wg - 1;
    const int tw = static_cast<int>(threadIdx.x) & 127;
    const int warp = tw >> 5, lane = tw & 31;
    const int my_turn = 1 + cw, their_turn = 2 - cw;
    const uint32_t q_wg = s_q + cw * 64 * 128;
    if (cw == 1) named_arrive(1);      // group 0 takes the first turn
    int st = 0;                        // ring position of the next kv tile
    uint32_t phase = 0;
    for (int r = 0;; ++r) {
      const int i = snake_tile(r, cta, grid);
      if (i >= n_tiles) break;
      const WorkTile w = work_tile(i, n_bh, h, n_qtiles);
      const int n_kt = kv_tiles(w.q0, sk, causal);
      const int qw0 = w.q0 + cw * 64;              // first row of the group
      const int row0 = qw0 + warp * 16 + (lane >> 2);  // and row0 + 8
      // kv tiles from this one on cross Sk or this group's diagonal
      const int k_edge = min(sk - WG_BK, causal ? qw0 - WG_BK + 1 : sk);

      float acc[DV / 2];
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) acc[j] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};
      float l_run[2] = {0.f, 0.f};    // this thread's columns only
      float s[64], alpha[2];
      uint32_t p[32];
      mbar_wait(full_q, r & 1);
      if (n_kt == 0) warp_arrive(empty_q, lane);
      if (n_kt > 0) {
        mbar_wait(full_k + 8 * st, phase);
        named_sync(my_turn);
        wgmma_fence();
        qk_product<D>(s, q_wg, s_k + st * T::K_BYTES);
        wgmma_commit();
        named_arrive(their_turn);
        wgmma_wait<0>();
        fence_regs(s);
        warp_arrive(empty_k + 8 * st, lane);
        if (n_kt == 1) warp_arrive(empty_q, lane);   // Q's last use
        softmax_tile(s, m_run, l_run, alpha, 0 > k_edge, 0, row0, lane, sk,
                     causal, scale_log2);
        rescale_and_pack<DV>(acc, p, s, alpha);
        for (int t = 1; t < n_kt; ++t) {
          // turn: kv tile t's S = Q K^T and kv tile t-1's O += P V, both
          // in flight while tile t's softmax runs
          const int prev = st;
          const uint32_t prev_phase = phase;
          if (++st == S) { st = 0; phase ^= 1; }
          mbar_wait(full_k + 8 * st, phase);
          mbar_wait(full_v + 8 * prev, prev_phase);
          named_sync(my_turn);
          wgmma_fence();
          qk_product<D>(s, q_wg, s_k + st * T::K_BYTES);
          wgmma_commit();
          pv_product<DV>(acc, p, s_v + prev * T::V_BYTES);
          wgmma_commit();
          named_arrive(their_turn);
          wgmma_wait<1>();             // S is in; P V still in flight
          fence_regs(s);
          warp_arrive(empty_k + 8 * st, lane);
          if (t == n_kt - 1) warp_arrive(empty_q, lane);   // Q's last use
          softmax_tile(s, m_run, l_run, alpha, t * WG_BK > k_edge,
                       t * WG_BK, row0, lane, sk, causal, scale_log2);
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(p);
          warp_arrive(empty_v + 8 * prev, lane);
          rescale_and_pack<DV>(acc, p, s, alpha);
        }
        // the work tile's last turn: its last kv tile's O += P V
        mbar_wait(full_v + 8 * st, phase);
        named_sync(my_turn);
        wgmma_fence();
        pv_product<DV>(acc, p, s_v + st * T::V_BYTES);
        wgmma_commit();
        named_arrive(their_turn);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(p);
        warp_arrive(empty_v + 8 * st, lane);
        if (++st == S) { st = 0; phase ^= 1; }
      }

      // acc / max(l, 1e-20) in bf16; rows at or beyond sq are not stored
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float l = l_run[half];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int qp = row0 + half * 8;
        if (qp >= sq) continue;
        // the log-sum-exp of the scaled scores: m_run is the raw max (the
        // exponentials took the scale in base 2), so ln l adds to scale m
        if (lse != nullptr && (lane & 3) == 0)
          lse[(static_cast<long long>(w.b) * sq + qp) * h + w.hh] =
              l > 0.f ? __fmul_rn(m_run[half], scale) + logf(fmaxf(l, 1e-30f))
                      : -INFINITY;
        const float inv_l = 1.f / fmaxf(l, 1e-20f);
        __nv_bfloat16* dst =
            o + ((static_cast<long long>(w.b) * sq + qp) * h + w.hh) * DV
            + (lane & 3) * 2;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
              __floats2bfloat162_rn(acc[4 * j + 2 * half] * inv_l,
                                    acc[4 * j + 2 * half + 1] * inv_l);
      }
    }
    // group 1's arrivals on barrier 1 lead group 0's turns by one (its
    // first hand-over above): group 0 takes it here, so none is left over
    if (cw == 0) named_sync(my_turn);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (the library links no -lcuda)
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A contiguous bf16 [B, S, N, D] array as a 4-D map over (D, N, S, B) with
// boxes of 64 x 1 x rows x 1 (one 128-byte panel of `rows` rows of one
// head), 128-byte swizzled. Rows beyond S read as zeros: a ragged tile
// never reaches the next sequence. Bases and strides must be 16-byte
// aligned (the wrapper checks the bases; D is 64, 128 or 192).
static bool encode_bsnd(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                        int d, int n, int s, int b, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t row = 2ull * d;
  const cuuint64_t strides[3] = {row, row * n, row * n * s};   // bytes
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV>
static int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                        float* lse, int b, int sq, int sk, int h, int kh,
                        float scale, int causal, int n_sm,
                        cudaStream_t stream) {
  using T = WgTile<D, DV>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode_bsnd(encode, &tq, q, D, h, sq, b, WG_BQ))
    return static_cast<int>(cudaErrorInvalidValue);
  if (sk > 0) {
    if (!encode_bsnd(encode, &tk, k, D, kh, sk, b, WG_BK)
        || !encode_bsnd(encode, &tv, v, DV, kh, sk, b, WG_BK))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    tk = tq;        // no kv tile is loaded: every row's output is 0
    tv = tq;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bh = b * h;
  const int n_qtiles = (sq + WG_BQ - 1) / WG_BQ;
  const long long tiles = static_cast<long long>(n_bh) * n_qtiles;
  const int grid = static_cast<int>(tiles < n_sm ? tiles : n_sm);
  flash_fwd_wgmma_kernel<D, DV><<<grid, WG_THREADS, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, n_bh, sq, sk, h, kh,
      n_qtiles, scale, scale * LOG2E, causal);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16; n_sm: the card's SM count (the bf16
// kernel's persistent grid). lse: null, or float32 [B, Sq, H] for the
// log-sum-exp of each row's scaled scores (m + ln l, -inf where l = 0: the
// residual the backward recomputes P from); out is the same either way.
// The wrapper checks shapes (Sq >= 1, D <= 192, DV <= 128, H a multiple of
// KH), types, contiguity and, for bf16 on the Hopper kernel, 16-byte
// aligned bases.
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int b, int sq, int sk, int h, int kh,
                                        int d, int dv, int dtype, int causal,
                                        float scale, int n_sm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1 && d == 128 && dv == 128)
    return launch_wgmma<128, 128>(q, k, v, o, l, b, sq, sk, h, kh, scale,
                                  causal, n_sm, s);
  if (dtype == 1 && d == 64 && dv == 64)
    return launch_wgmma<64, 64>(q, k, v, o, l, b, sq, sk, h, kh, scale,
                                causal, n_sm, s);
  if (dtype == 1 && d == 192 && dv == 128)
    return launch_wgmma<192, 128>(q, k, v, o, l, b, sq, sk, h, kh, scale,
                                  causal, n_sm, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, l, b, sq, sk, h, kh, d, dv,
                                   scale, causal, s);
  return launch_d<float>(q, k, v, o, l, b, sq, sk, h, kh, d, dv, scale,
                         causal, s);
}
