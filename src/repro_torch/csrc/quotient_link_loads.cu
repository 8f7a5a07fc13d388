// Per-link makespan communication loads from an arc list (core/objective.py
// and every refinement round of core/refine.py):
//
//     W[i, j] = sum of w[a] over arcs a with part[s[a]] = i, part[r[a]] = j
//     out[l]  = F_l[l] * 0.5 * sum_{i: S[l,i] != 0} S[l,i] *
//               sum_j (W[i,j] + W[j,i] - 2 W[i,j] S[l,j])
//             = F_l[l] * 0.5 * (S r + S c - 2 diag(S W S^T))[l]
//
// Replaces the Pallas kernel repro/kernels/quotient_link_loads.py:
// quotient_link_loads (and the part[senders] / part[receivers] gathers of
// repro/kernels/ops.py:link_loads, which are fused into the scatter here).
//
// The TPU kernel carries W in one VMEM scratch across a sequential grid.
// Hopper blocks run in no order; here one cooperative launch does the whole
// call, with no fill before it:
//
//   1. Every block zeroes its slice of the other half of a double-buffered
//      device workspace (the half the previous call used) and block 0
//      zeroes out, while every warp loads S and F_l for the links it will
//      sum.
//   2. Scatter: each block takes one contiguous chunk of the CSR-ordered
//      arcs and each warp a contiguous stretch of it, 4 arcs a lane in
//      flight (all loads of senders, receivers and weight issued, then all
//      part[] gathers). Each lane keeps the sums of the 8 bin pairs it met
//      last in registers, most recent first: in the path's partitions a
//      stretch meets a few bin pairs at a time, so its adds stay there, and
//      the warp's cached pairs go into W at the end, equal pairs summed
//      across the lanes first, as fire-and-forget float reductions in L2. A
//      new pair evicts the oldest: where W fits (k <= 128), into the
//      block's own W in shared memory, which the block adds into the
//      workspace once at the end; else into the workspace directly. Float
//      atomics on shared memory are compare-and-swap loops on this card:
//      the cache keeps the hot pairs of a CSR-local chunk out of them, and
//      evictions, which scatter, rarely collide (PERF.md section 6).
//   3. One grid barrier (the launch is cooperative, so every block is
//      resident; its counter is in the same half of the workspace).
//   4. Epilogue, spread over every warp of the grid: a warp per (link l,
//      32 bins i) where S[l, i] is nonzero adds its share of out[l] with one
//      reduction, reading the rows and columns of its bins' W from L2; the
//      blocks copy W out in slices.
//
// The next call zeroes this call's half, so the workspace costs no fill and
// needs no last block. The wrapper owns it (one per device and k, zeroed
// once) and flips the half with every call; calls sharing it must be
// ordered, so it is used on the current stream only.
//
// Bound: the scatter reads 12 B per arc plus part (4 B per vertex); W and
// S stay in L2. At m = 1,548,288 arcs that is ~19.6 MB, ~5.9 us at
// 3.35 TB/s. Float atomics make the summation order vary from run to run,
// so results match the plain version to allclose, not bitwise.
//
// Internal linkage without an anonymous namespace, so the kernel keeps a
// plain mangled name in nvcc's -Xptxas -v report.
#include "common.cuh"

static constexpr unsigned kFull = 0xffffffffu;
static constexpr int kArcsPerLane = 4;
static constexpr int kSpan = 32 * kArcsPerLane;  // arcs per warp step
static constexpr int kWays = 8;    // cached bin pairs per lane
static constexpr int kHeld = 4;    // S chunks a lane holds (k <= 128)

static __device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// *p += v in device memory, fire and forget (a float reduction in L2).
static __device__ __forceinline__ void red_add(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;"
               :
               : "l"(__cvta_generic_to_global(p)), "f"(v)
               : "memory");
}

// Scatter arcs [begin, end) into acc (device memory): see step 2 above.
// Evicted sums go into s_w (the block's W in shared memory) where kSmemW.
template <bool kSmemW>
static __device__ __forceinline__ void scatter(
    const int* __restrict__ part, const int* __restrict__ senders,
    const int* __restrict__ receivers, const float* __restrict__ weight,
    long long begin, long long end, int k, float* acc, float* s_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  long long per_warp = (end - begin + n_warps - 1) / n_warps;
  per_warp = (per_warp + kSpan - 1) / kSpan * kSpan;
  const long long wbegin = begin + warp * per_warp;
  const long long wend = wbegin + per_warp < end ? wbegin + per_warp : end;
  int ck[kWays];
  float cv[kWays];
#pragma unroll
  for (int w = 0; w < kWays; ++w) {
    ck[w] = -1;
    cv[w] = 0.0f;
  }
  for (long long base = wbegin; base < wend; base += kSpan) {
    int src[kArcsPerLane], dst[kArcsPerLane];
    float x[kArcsPerLane];
#pragma unroll
    for (int q = 0; q < kArcsPerLane; ++q) {
      const long long a = base + q * 32 + lane;
      const bool ok = a < wend;
      src[q] = ok ? __ldg(senders + a) : -1;
      dst[q] = ok ? __ldg(receivers + a) : -1;
      x[q] = ok ? __ldg(weight + a) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kArcsPerLane; ++q) {
      const int bi = src[q] >= 0 ? __ldg(part + src[q]) : -1;
      const int bj = dst[q] >= 0 ? __ldg(part + dst[q]) : -1;
      src[q] = static_cast<unsigned>(bi) < static_cast<unsigned>(k) &&
                       static_cast<unsigned>(bj) < static_cast<unsigned>(k)
                   ? bi * k + bj
                   : -1;                                 // the arc's key
    }
#pragma unroll
    for (int q = 0; q < kArcsPerLane; ++q) {
      const int key = src[q];
      if (key < 0) continue;
      if (ck[0] == key) {                  // the most recent pair: most arcs
        cv[0] += x[q];
        continue;
      }
      int pos = kWays - 1;                 // a hit's way, else the oldest
#pragma unroll
      for (int w = 1; w < kWays; ++w)
        if (ck[w] == key) pos = w;
      float v = x[q];
#pragma unroll
      for (int w = 1; w < kWays; ++w)
        if (w == pos) {
          if (ck[w] == key)
            v += cv[w];
          else if (ck[w] >= 0 && kSmemW)
            atomicAdd(s_w + ck[w], cv[w]);
          else if (ck[w] >= 0)
            red_add(acc + ck[w], cv[w]);
        }
#pragma unroll
      for (int w = kWays - 1; w >= 1; --w)  // the others one way older
        if (w <= pos) {
          ck[w] = ck[w - 1];
          cv[w] = cv[w - 1];
        }
      ck[0] = key;
      cv[0] = v;
    }
  }
#pragma unroll
  for (int w = 0; w < kWays; ++w) {
    const unsigned group = __match_any_sync(kFull, ck[w]);
    float sum = 0.0f;
    for (int l = 0; l < 32; ++l) {
      const float y = __shfl_sync(kFull, cv[w], l);
      if ((group >> l) & 1u) sum += y;
    }
    if (ck[w] >= 0 && lane == __ffs(group) - 1) red_add(acc + ck[w], sum);
  }
}

// S[l, 32c + lane] and, where k <= 32 * kHeld, every S[l, 32jc + lane].
static __device__ __forceinline__ void load_unit(const float* __restrict__ Sl,
                                                 int k, int c, bool hold,
                                                 float& si, float* held) {
  const int lane = threadIdx.x & 31, chunks = (k + 31) >> 5;
  si = (c << 5) + lane < k ? __ldg(Sl + (c << 5) + lane) : 0.0f;
#pragma unroll
  for (int jc = 0; jc < kHeld; ++jc)
    held[jc] = hold && jc < chunks && (jc << 5) + lane < k
                   ? __ldg(Sl + (jc << 5) + lane)
                   : 0.0f;
}

// out[l] += F_l[l] * 0.5 * sum_{i in chunk c, S[l,i] != 0} S[l,i] *
//           sum_j (W[i,j] + W[j,i] - 2 W[i,j] S[l,j])
// for unit (l, c), by one warp; si and held from load_unit.
static __device__ __forceinline__ void link_unit(
    const float* W, const float* __restrict__ Sl, float si, const float* held,
    bool hold, float f, int k, int l, int c, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, chunks = (k + 31) >> 5;
  float sum = 0.0f;
  for (unsigned rows = __ballot_sync(kFull, si != 0.0f); rows;
       rows &= rows - 1) {
    const int b = __ffs(rows) - 1;
    const int i = (c << 5) + b;
    const float s = __shfl_sync(kFull, si, b);
    if (hold) {
#pragma unroll
      for (int jc = 0; jc < kHeld; ++jc) {
        const int j = (jc << 5) + lane;
        if (jc < chunks && j < k) {
          const float wij = __ldcg(W + i * k + j);
          const float wji = __ldcg(W + j * k + i);
          sum += s * (wij + wji - 2.0f * wij * held[jc]);
        }
      }
    } else {
#pragma unroll 4
      for (int jc = 0; jc < chunks; ++jc) {
        const int j = (jc << 5) + lane;
        if (j < k) {
          const float wij = __ldcg(W + i * k + j);
          const float wji = __ldcg(W + j * k + i);
          sum += s * (wij + wji - 2.0f * wij * __ldg(Sl + j));
        }
      }
    }
  }
  sum = warp_sum(sum);
  if (lane == 0 && sum != 0.0f) red_add(out + l, f * (0.5f * sum));
}

// kSmemW: the block keeps the pairs its lanes evict in its own W in shared
// memory and adds its nonzero entries into acc at the end.
template <bool kSmemW>
__global__ void __launch_bounds__(512, 2) qll_kernel(
    const int* __restrict__ part, const int* __restrict__ senders,
    const int* __restrict__ receivers, const float* __restrict__ weight,
    long long m, long long per_block, const float* __restrict__ S,
    const float* __restrict__ F_l, int n_links, int k, float* W,
    float* __restrict__ out, float* acc, unsigned* count, float* other,
    unsigned* other_count) {
  extern __shared__ float s_w[];                   // [k*k] if kSmemW
  const int t = threadIdx.x;
  const int n_threads = blockDim.x, n_warps = n_threads >> 5;
  const int blocks = gridDim.x, b = blockIdx.x;
  const int kk = k * k, chunks = (k + 31) >> 5;
  const int units = n_links * chunks;
  const int gwarp = b * n_warps + (t >> 5), all_warps = blocks * n_warps;
  const bool hold = chunks <= kHeld;

  // 1. the other half zeroed; this warp's first unit's S and F_l in flight
  const long long z0 = static_cast<long long>(kk) * b / blocks;
  const long long z1 = static_cast<long long>(kk) * (b + 1) / blocks;
  for (long long i = z0 + t; i < z1; i += n_threads) other[i] = 0.0f;
  if (b == 0) {
    if (t == 0) *other_count = 0u;
    for (int l = t; l < n_links; l += n_threads) out[l] = 0.0f;
  }
  float si = 0.0f, f = 0.0f, held[kHeld];
  if (gwarp < units) {
    const int l = gwarp / chunks;
    load_unit(S + static_cast<long long>(l) * k, k, gwarp - l * chunks, hold,
              si, held);
    f = __ldg(F_l + l);
  }

  // 2. scatter
  if (kSmemW) {
    for (int i = t; i < kk; i += n_threads) s_w[i] = 0.0f;
    __syncthreads();
  }
  const long long begin = b * per_block;
  const long long end = begin + per_block < m ? begin + per_block : m;
  scatter<kSmemW>(part, senders, receivers, weight, begin, end, k, acc, s_w);
  if (kSmemW) {
    __syncthreads();
    for (int i = t; i < kk; i += n_threads)
      if (s_w[i] != 0.0f) red_add(acc + i, s_w[i]);
  }

  // 3. every block's reductions (and zeroing) done before anyone reads W
  __threadfence();
  __syncthreads();
  if (blocks > 1) {
    if (t == 0) {
      atomicAdd(count, 1u);
      while (*reinterpret_cast<volatile unsigned*>(count) <
             static_cast<unsigned>(blocks)) {
      }
      __threadfence();
    }
    __syncthreads();
  }

  // 4. the links, then W out in slices
  for (int u = gwarp; u < units; u += all_warps) {
    const int l = u / chunks, c = u - l * chunks;
    const float* Sl = S + static_cast<long long>(l) * k;
    if (u != gwarp) {                      // past the first unit: load now
      load_unit(Sl, k, c, hold, si, held);
      f = __ldg(F_l + l);
    }
    link_unit(acc, Sl, si, held, hold, f, k, l, c, out);
  }
  for (long long i = z0 + t; i < z1; i += n_threads) W[i] = __ldcg(acc + i);
}

// One cooperative launch of kernels/quotient_link_loads.py's plan: gx
// blocks of bx threads (a whole number of warps, at most 512), with
// smem_bytes = 4 k^2 of shared memory for each block's W, or 0. A grid the
// card cannot hold at once is refused by the launch
// (cudaErrorCooperativeLaunchTooLarge), never cut. `work` is the
// workspace: two halves of k*k floats, then their two barrier counters,
// all zero before the first call; `half` (0 or 1) is this call's, the
// other is zeroed for the next call.
REPRO_EXPORT int quotient_link_loads_launch(
    const void* part, const void* senders, const void* receivers,
    const void* weight, long long m, const void* subtree, const void* F_l,
    int n_links, int k, void* W, void* out, void* work, int half,
    REPRO_LAUNCH_PARAMS) {
  ReproLaunch L;
  if (!repro_launch_dims(gx, gy, gz, bx, by, bz, smem_bytes, 512, &L) ||
      gy != 1 || gz != 1 || by != 1 || bz != 1 || bx % 32 != 0 ||
      (smem_bytes != 0 && smem_bytes != 4LL * k * k))
    return REPRO_BAD_LAUNCH;
  auto kernel = smem_bytes ? qll_kernel<true> : qll_kernel<false>;
  cudaError_t e = repro_smem_optin(kernel, L.smem);
  if (e != cudaSuccess) return repro_fail(e);
  const int blocks = gx;
  long long per_block = (m + blocks - 1) / blocks;
  per_block = (per_block + kSpan - 1) / kSpan * kSpan;
  const long long kk = static_cast<long long>(k) * k;
  float* ws = static_cast<float*>(work);
  unsigned* counts = reinterpret_cast<unsigned*>(ws + 2 * kk);
  float* acc = ws + half * kk;
  float* other = ws + (1 - half) * kk;
  unsigned* count = counts + half;
  unsigned* other_count = counts + (1 - half);
  const int* p_part = static_cast<const int*>(part);
  const int* p_s = static_cast<const int*>(senders);
  const int* p_r = static_cast<const int*>(receivers);
  const float* p_w = static_cast<const float*>(weight);
  const float* p_S = static_cast<const float*>(subtree);
  const float* p_F = static_cast<const float*>(F_l);
  float* p_W = static_cast<float*>(W);
  float* p_out = static_cast<float*>(out);
  void* args[] = {&p_part, &p_s, &p_r, &p_w, &m, &per_block, &p_S, &p_F,
                  &n_links, &k, &p_W, &p_out, &acc, &count, &other,
                  &other_count};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), L.grid,
                                  L.block, args, L.smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return repro_fail(e);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT const void* quotient_link_loads_kernel_of(const char* name) {
  if (std::strcmp(name, "qll_kernel<true>") == 0)
    return reinterpret_cast<const void*>(qll_kernel<true>);
  if (std::strcmp(name, "qll_kernel<false>") == 0)
    return reinterpret_cast<const void*>(qll_kernel<false>);
  return nullptr;
}
