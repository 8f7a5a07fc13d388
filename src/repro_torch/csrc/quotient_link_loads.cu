// Per-link makespan communication loads from an arc list (core/objective.py
// and every refinement round of core/refine.py):
//
//     W[i, j] = sum of w[a] over arcs a with part[s[a]] = i, part[r[a]] = j
//     out[l]  = F_l[l] * 0.5 * (S r + S c - 2 diag(S W S^T))[l]
//
// Replaces the Pallas kernel repro/kernels/quotient_link_loads.py:
// quotient_link_loads (and the part[senders] / part[receivers] gathers of
// repro/kernels/ops.py:link_loads, which are fused into the scatter here).
//
// The TPU kernel carries W in one VMEM scratch across a sequential grid.
// Hopper blocks run in no order, so this is two launches:
//
//   1. scatter: each block walks a grid-stride share of the arcs, gathers
//      both endpoint bins, and adds w into W. For k*k*4 B <= 48 KB (k <= 110;
//      k = 64 on gpu-superpod is 16 KB) each block keeps a private W in
//      shared memory and flushes its nonzero entries into the zeroed global W
//      with atomicAdd; for larger k (512 on production_tree(2, 16, 16)) it
//      adds into global W directly. Arcs are CSR-ordered and neighbouring
//      vertices mostly share a bin, so many lanes of a warp hit the same W
//      entry: lanes with equal keys are grouped with __match_any_sync and
//      summed by shuffles, and only each group's leader does an atomic add.
//   2. epilogue: one block per link l computes
//        0.5 * sum_{i: S[l,i] != 0} S[l,i] * sum_j (W[i,j] + W[j,i] - 2 W[i,j] S[l,j])
//      which equals S r + S c - 2 diag(S W S^T) with r/c the row/column
//      sums, and multiplies by F_l. Rows with S[l,i] = 0 add nothing and are
//      skipped, so a tree's epilogue reads about depth * k rows of W.
//
// Bound: the scatter reads 12 B per arc plus part (4 B per vertex); W and
// S stay in L2. At m = 1,548,288 arcs that is ~19.6 MB, ~5.9 us at
// 3.35 TB/s. Float atomics make the summation order vary from run to run,
// so results match the plain version to allclose, not bitwise.
#include "common.cuh"

template <bool kShared>
__global__ void qll_scatter_kernel(const int* __restrict__ part,
                                   const int* __restrict__ senders,
                                   const int* __restrict__ receivers,
                                   const float* __restrict__ weight,
                                   long long m, int k, float* __restrict__ W) {
  extern __shared__ float s_w[];
  float* acc = kShared ? s_w : W;
  const int kk = k * k;
  if (kShared) {
    for (int i = threadIdx.x; i < kk; i += blockDim.x) s_w[i] = 0.0f;
    __syncthreads();
  }
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // every lane of a warp runs the same number of iterations (the bound is
  // rounded up per warp) so the warp-wide shuffles below stay converged
  long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                   (threadIdx.x & ~31);
  for (; base < m; base += stride) {
    long long a = base + lane;
    int key = -1;
    float x = 0.0f;
    if (a < m) {
      int bi = part[senders[a]];
      int bj = part[receivers[a]];
      if (static_cast<unsigned>(bi) < static_cast<unsigned>(k) &&
          static_cast<unsigned>(bj) < static_cast<unsigned>(k)) {
        key = bi * k + bj;
        x = weight[a];
      }
    }
    unsigned group = __match_any_sync(full, key);
    float sum = 0.0f;
    for (int src = 0; src < 32; ++src) {
      float v = __shfl_sync(full, x, src);
      if ((group >> src) & 1u) sum += v;
    }
    if (key >= 0 && lane == __ffs(group) - 1) atomicAdd(&acc[key], sum);
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < kk; i += blockDim.x) {
      float v = s_w[i];
      if (v != 0.0f) atomicAdd(&W[i], v);
    }
  }
}

__global__ void qll_epilogue_kernel(const float* __restrict__ W,
                                    const float* __restrict__ subtree,
                                    const float* __restrict__ F_l,
                                    float* __restrict__ out, int k) {
  extern __shared__ float s_row[];  // S[l, :], then 32 warp partials
  float* s_part = s_row + k;
  const int l = blockIdx.x;
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    s_row[j] = subtree[static_cast<long long>(l) * k + j];
  __syncthreads();
  float acc = 0.0f;
  for (int i = 0; i < k; ++i) {
    float si = s_row[i];
    if (si == 0.0f) continue;  // same branch for the whole block
    const float* row = W + static_cast<long long>(i) * k;
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      float wij = row[j];
      acc += si * (wij + W[static_cast<long long>(j) * k + i] -
                   2.0f * wij * s_row[j]);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) s_part[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int q = 0; q < (blockDim.x + 31) / 32; ++q) total += s_part[q];
    out[l] = F_l[l] * (0.5f * total);
  }
}

// W must be a zeroed float buffer of k*k entries on the same stream.
REPRO_EXPORT int quotient_link_loads_launch(
    const void* part, const void* senders, const void* receivers,
    const void* weight, long long m, const void* subtree, const void* F_l,
    int n_links, int k, void* W, void* out, int n_sm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 512;
  int blocks = repro_blocks_for(m, threads, n_sm * 2);
  size_t w_bytes = static_cast<size_t>(k) * k * sizeof(float);
  if (w_bytes <= 48 * 1024) {
    qll_scatter_kernel<true><<<blocks, threads, w_bytes, st>>>(
        static_cast<const int*>(part), static_cast<const int*>(senders),
        static_cast<const int*>(receivers), static_cast<const float*>(weight),
        m, k, static_cast<float*>(W));
  } else {
    qll_scatter_kernel<false><<<repro_blocks_for(m, threads, n_sm * 8),
                                threads, 0, st>>>(
        static_cast<const int*>(part), static_cast<const int*>(senders),
        static_cast<const int*>(receivers), static_cast<const float*>(weight),
        m, k, static_cast<float*>(W));
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_links == 0) return err;
  const int ep_threads = 256;
  size_t ep_smem = (static_cast<size_t>(k) + 32) * sizeof(float);
  qll_epilogue_kernel<<<n_links, ep_threads, ep_smem, st>>>(
      static_cast<const float*>(W), static_cast<const float*>(subtree),
      static_cast<const float*>(F_l), static_cast<float*>(out), k);
  return static_cast<int>(cudaGetLastError());
}
