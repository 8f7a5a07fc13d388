// Block-sparse matrix product over BSR blocks (GIN's sum aggregation):
//
//     out[r*R + m, f] = sum over blocks t of block row r, in column order,
//                       sum over k of A_t[m, k] * x[cols[t]*R + k, f]
//
// Replaces the Pallas kernel repro/kernels/bsr_spmm.py:bsr_spmm. That
// kernel walks the nonzero blocks as a sequential grid axis and keeps a
// block row's output tile resident in VMEM from one grid step to the next;
// Hopper runs its blocks in no order, so the walk moves inside the block:
// one CUDA block per (block row, row tile, feature tile) loops over
// row_ptr[r] .. row_ptr[r+1] in slabs of 16 columns of A_t and accumulates
// its output tile in registers, TM x TN values per thread. Each output
// element is written once, at the end: no atomics, no zero-fill pass, and
// a fixed summation order (blocks in column order, k ascending, one fmaf
// per term), so the result is deterministic. Rows past R and columns past
// F are masked, so any R and F are taken.
//
// Only slabs that hold a nonzero are read. The layout carries one bit per
// 16 x 16 sub-block (occ[t, s] bit j: rows 16s.., columns 16j.. of block t;
// ops.prepare_bsr builds it once per layout), and a row tile reads the
// slabs whose bit is set in any of its 16-row strips. A skipped slab's
// terms are fmaf(0, x, acc) == acc for finite x, and the accumulator starts
// at +0, so for finite x the result is bitwise that of the dense walk. A
// non-finite x meeting a stored zero gives what the reference's XLA path
// (ops.gnn_aggregate, a segment_sum over the arcs) gives where the whole
// slab is zero, not the dense product's NaN.
//
// The slabs of A_t and of the x tile go through a ring of kStages buffers
// in shared memory, filled by 16-byte cp.async (4-byte where R or F is not
// a multiple of 4 or a base is unaligned), each buffer with an mbarrier
// that every thread's copies arrive on (cp.async.mbarrier.arrive.noinc),
// so kStages - 1 slabs are in flight while one is multiplied; one
// __syncthreads per slab frees the buffer that the next copy refills. The
// block first lists its nonzero slabs in shared memory (one thread per
// block of the row: OR of its strips' bits, a scan for the offsets), in
// chunks of at most NT blocks.
//
// Bound on the H100 (SXM, 700 W) at GIN-TU's bulk batch (16,384 molecules,
// 3,840 block rows, 11,008 blocks of 128 x 128, 1,947,010 nonzeros,
// F = 64): x and out once each (126 MB each) and every nonzero's value and
// position (8 bytes each, 15.6 MB) are 267 MB, 0.080 ms at 3.35 TB/s;
// the product is one multiply-add per nonzero and feature, 0.25 GFLOP,
// 0.004 ms at the 67 TFLOP/s float32 (non-tensor) peak: bound by bytes.
// Reading every stored block (721 MB) would take 0.290 ms. The kernel
// reads the nonzero 32 x 16 slabs, 20% of the blocks' bytes there, and
// does their dense products in fmaf from shared memory (4.6 GFLOP, 0.069
// ms at that peak: the slabs' bytes and latency, not the arithmetic, set
// its time, so tensor cores would not pay).
//
// Tiles (rows x features, threads): 32 x 64 (128 threads, 4 x 4 each)
// when its grid gives every multiprocessor 16 blocks, else 16 x 64 (64
// threads), which reads fewer all-zero slabs and makes twice the grid (a
// 30-block-row molecule request gets 240 blocks); the wrapper picks.
#include <cstdint>

#include "common.cuh"

constexpr int kGrain = 16;      // occupancy granule and slab depth
constexpr int kListCap = 1024;  // listed slabs per chunk of blocks
constexpr int kStages = 4;      // ring buffers: kStages - 1 slabs in flight

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes device -> shared, asynchronously; zero-filled when !ok
static __device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                                  bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

static __device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                                 bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

static __device__ __forceinline__ void mbar_init(uint64_t* bar,
                                                 uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// this thread's earlier cp.asyncs arrive on bar once they have landed
static __device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// (A wait that outlasts ~2^26 polls, seconds, is a fault: the launch
// fails with an error instead of hanging the card.)
static __device__ __forceinline__ void mbar_wait(uint64_t* bar,
                                                 uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (++polls == (1u << 26)) __trap();
  } while (!done);
}

// Exclusive prefix sum of v over the block (NT threads); *total gets the
// sum. Uses warp_sums[NT / 32] of shared memory.
template <int NT>
static __device__ __forceinline__ int block_scan(int v, int* warp_sums,
                                                 int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    if (w < warp) before += warp_sums[w];
    all += warp_sums[w];
  }
  *total = all;
  return before + inc - v;
}

template <int BM, int BN, int TM, int TN, bool VEC>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
bsr_spmm_kernel(const int* __restrict__ row_ptr,
                const int* __restrict__ cols,
                const int* __restrict__ occ,
                const float* __restrict__ blocks,
                const float* __restrict__ x, float* __restrict__ out, int r,
                int f, int m_tiles) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int BK = kGrain;
  constexpr int NV = TN / 4;              // float4 columns per thread
  constexpr int kColGroups = BN / TN;
  static_assert(NT % 32 == 0 && TN % 4 == 0 && BM % kGrain == 0,
                "whole warps, float4 columns, whole strips");
  static_assert((BM * BK) % (4 * NT) == 0 && (BK * BN) % (4 * NT) == 0,
                "every thread copies the same share of a slab");
  __shared__ __align__(16) float a_s[kStages][BM * BK];
  __shared__ __align__(16) float x_s[kStages][BK * BN];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ int list[kListCap];          // (block in chunk) << 16 | slab
  __shared__ int col_s[NT];
  __shared__ int warp_sums[NT / 32];

  const int brow = blockIdx.x / m_tiles;
  const int m0 = (blockIdx.x - brow * m_tiles) * BM;
  const int f0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int row0 = (tid / kColGroups) * TM;
  const int col0 = (tid % kColGroups) * 4;
  const long long rr = static_cast<long long>(r) * r;
  const long long rf = static_cast<long long>(r) * f;
  const int rt = (r + kGrain - 1) / kGrain;     // strips (and slabs) a block
  const int words = (rt + 31) / 32;
  const int s_lo = m0 / kGrain, s_hi = min((m0 + BM) / kGrain, rt);
  const int chunk = min(NT, kListCap / rt);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], NT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // copy listed slab e into ring buffer st, arriving on its barrier
  auto issue = [&](int e, int t0, int st) {
    const int tb = e >> 16, k0 = (e & 0xffff) * BK;
    const float* a = blocks + static_cast<long long>(t0 + tb) * rr;
    const float* xb = x + static_cast<long long>(col_s[tb]) * rf;
    if (VEC) {
#pragma unroll
      for (int q = 0; q < BM * BK / (4 * NT); ++q) {
        const int c = tid + q * NT, m = c / (BK / 4), kq = (c % (BK / 4)) * 4;
        const bool ok = m0 + m < r && k0 + kq < r;
        cp_async16(&a_s[st][m * BK + kq],
                   ok ? a + static_cast<long long>(m0 + m) * r + k0 + kq : a,
                   ok);
      }
#pragma unroll
      for (int q = 0; q < BK * BN / (4 * NT); ++q) {
        const int c = tid + q * NT, k = c / (BN / 4), cq = (c % (BN / 4)) * 4;
        const bool ok = k0 + k < r && f0 + cq < f;
        cp_async16(&x_s[st][k * BN + cq],
                   ok ? xb + static_cast<long long>(k0 + k) * f + f0 + cq
                      : xb,
                   ok);
      }
    } else {
#pragma unroll
      for (int q = 0; q < BM * BK / NT; ++q) {
        const int c = tid + q * NT, m = c / BK, k = c % BK;
        const bool ok = m0 + m < r && k0 + k < r;
        cp_async4(&a_s[st][m * BK + k],
                  ok ? a + static_cast<long long>(m0 + m) * r + k0 + k : a,
                  ok);
      }
#pragma unroll
      for (int q = 0; q < BK * BN / NT; ++q) {
        const int c = tid + q * NT, k = c / BN, cc = c % BN;
        const bool ok = k0 + k < r && f0 + cc < f;
        cp_async4(&x_s[st][k * BN + cc],
                  ok ? xb + static_cast<long long>(k0 + k) * f + f0 + cc
                     : xb,
                  ok);
      }
    }
    mbar_arrive_cp_async(&full[st]);
  };

  const int t_end = row_ptr[brow + 1];
  unsigned g = 0;                         // slabs taken so far: ring slot
  for (int t0 = row_ptr[brow]; t0 < t_end; t0 += chunk) {
    const int nb = min(chunk, t_end - t0);
    // list this chunk's nonzero slabs: block t0 + tid, slabs ascending
    int mine = 0;
    if (tid < nb) {
      const int* o = occ + static_cast<long long>(t0 + tid) * rt * words;
      for (int w = 0; w < words; ++w) {
        unsigned bits = 0;
        for (int s = s_lo; s < s_hi; ++s) bits |= o[s * words + w];
        mine += __popc(bits);
      }
      col_s[tid] = cols[t0 + tid];
    }
    int total;
    int at = block_scan<NT>(mine, warp_sums, &total);
    if (tid < nb) {
      const int* o = occ + static_cast<long long>(t0 + tid) * rt * words;
      for (int w = 0; w < words; ++w) {
        unsigned bits = 0;
        for (int s = s_lo; s < s_hi; ++s) bits |= o[s * words + w];
        while (bits) {
          list[at++] = (tid << 16) | (w * 32 + __ffs(bits) - 1);
          bits &= bits - 1;
        }
      }
    }
    __syncthreads();

    for (int p = 0; p < kStages - 1 && p < total; ++p)
      issue(list[p], t0, (g + p) % kStages);
    for (int i = 0; i < total; ++i) {
      const int st = (g + i) % kStages;
      mbar_wait(&full[st], ((g + i) / kStages) & 1);
      __syncthreads();                    // every thread is past slab i - 1
      if (i + kStages - 1 < total)
        issue(list[i + kStages - 1], t0, (g + i + kStages - 1) % kStages);
      const float* as = a_s[st];
      const float* xs = x_s[st];
#pragma unroll
      for (int kq = 0; kq < BK; kq += 4) {
        float4 xv[4][NV];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int v = 0; v < NV; ++v)
            xv[kk][v] = *reinterpret_cast<const float4*>(
                &xs[(kq + kk) * BN + v * (BN / NV) + col0]);
#pragma unroll
        for (int i2 = 0; i2 < TM; ++i2) {
          const float4 av =
              *reinterpret_cast<const float4*>(&as[(row0 + i2) * BK + kq]);
          const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              float* c = &acc[i2][v * 4];
              c[0] = fmaf(a4[kk], xv[kk][v].x, c[0]);
              c[1] = fmaf(a4[kk], xv[kk][v].y, c[1]);
              c[2] = fmaf(a4[kk], xv[kk][v].z, c[2]);
              c[3] = fmaf(a4[kk], xv[kk][v].w, c[3]);
            }
        }
      }
    }
    g += total;
    __syncthreads();                      // the list is rewritten next
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + row0 + i;
    if (gm >= r) continue;
    float* o = out + (static_cast<long long>(brow) * r + gm) * f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int gc = f0 + v * (BN / NV) + col0;
      if (VEC) {
        if (gc < f)
          *reinterpret_cast<float4*>(o + gc) = make_float4(
              acc[i][v * 4], acc[i][v * 4 + 1], acc[i][v * 4 + 2],
              acc[i][v * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < f) o[gc + j] = acc[i][v * 4 + j];
      }
    }
  }
}

template <int BM, int BN, int TM, int TN>
static int bsr_spmm_enqueue(const ReproLaunch& L, const int* row_ptr,
                            const int* cols, const int* occ,
                            const float* blocks, const float* x, float* out,
                            int r, int f, bool vec, cudaStream_t stream) {
  const int m_tiles = (r + BM - 1) / BM;
  if (L.block.x != (BM / TM) * (BN / TN) || L.block.y != 1 ||
      L.block.z != 1 || L.grid.z != 1 || L.smem != 0)
    return REPRO_BAD_LAUNCH;
  if (vec)
    bsr_spmm_kernel<BM, BN, TM, TN, true><<<L.grid, L.block, 0, stream>>>(
        row_ptr, cols, occ, blocks, x, out, r, f, m_tiles);
  else
    bsr_spmm_kernel<BM, BN, TM, TN, false><<<L.grid, L.block, 0, stream>>>(
        row_ptr, cols, occ, blocks, x, out, r, f, m_tiles);
  return static_cast<int>(cudaGetLastError());
}

// The launch of kernels/bsr_spmm.py's plan: grid (block rows x row tiles,
// feature tiles), one thread per 4 x 4 outputs of the tile. wide != 0: the
// 32 x 64 tile, else the 16 x 64 one; vec != 0: R and F multiples of 4 and
// 16-byte aligned bases. A block that disagrees with the tile is refused.
REPRO_EXPORT int bsr_spmm_launch(const void* row_ptr, const void* cols,
                                 const void* occ, const void* blocks,
                                 const void* x, void* out, int n_block_rows,
                                 int r, int f, int wide, int vec,
                                 REPRO_LAUNCH_PARAMS) {
  ReproLaunch L;
  if (!repro_launch_dims(gx, gy, gz, bx, by, bz, smem_bytes, 128, &L))
    return REPRO_BAD_LAUNCH;
  auto s = static_cast<cudaStream_t>(stream);
  auto rp = static_cast<const int*>(row_ptr);
  auto cl = static_cast<const int*>(cols);
  auto oc = static_cast<const int*>(occ);
  auto bl = static_cast<const float*>(blocks);
  auto xx = static_cast<const float*>(x);
  auto o = static_cast<float*>(out);
  const bool v = vec != 0;
  if (wide)
    return bsr_spmm_enqueue<32, 64, 4, 4>(L, rp, cl, oc, bl, xx, o, r, f, v,
                                          s);
  return bsr_spmm_enqueue<16, 64, 4, 4>(L, rp, cl, oc, bl, xx, o, r, f, v, s);
}

REPRO_EXPORT const void* bsr_spmm_kernel_of(const char* name) {
  if (std::strcmp(name, "bsr_spmm_kernel<32,64,4,4,1>") == 0)
    return reinterpret_cast<const void*>(bsr_spmm_kernel<32, 64, 4, 4, true>);
  if (std::strcmp(name, "bsr_spmm_kernel<32,64,4,4,0>") == 0)
    return reinterpret_cast<const void*>(
        bsr_spmm_kernel<32, 64, 4, 4, false>);
  if (std::strcmp(name, "bsr_spmm_kernel<16,64,4,4,1>") == 0)
    return reinterpret_cast<const void*>(bsr_spmm_kernel<16, 64, 4, 4, true>);
  if (std::strcmp(name, "bsr_spmm_kernel<16,64,4,4,0>") == 0)
    return reinterpret_cast<const void*>(
        bsr_spmm_kernel<16, 64, 4, 4, false>);
  return nullptr;
}
