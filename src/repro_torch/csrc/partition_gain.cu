// Connectivity rows of the dense refinement round (core/refine.py):
//
//     conn[v, j] = sum over ELL slots d of w[v, d] * [part[nbr[v, d]] = j]
//
// Replaces the Pallas kernel repro/kernels/partition_gain.py:
// partition_gain_ell and fuses the part[nbr_idx] gather of
// repro/kernels/ops.py:partition_gain_pallas. Padding slots hold the
// sentinel neighbour id n (weight 0) and are skipped, as bin k is in the
// TPU kernel's one-hot.
//
// Each block owns a tile of rows with a [rows, k] float accumulator in
// shared memory (row stride k|1, odd, so the 32 rows a warp touches fall in
// distinct banks). One thread per row walks its D slots in order, so the
// per-row sum order is fixed and the result is deterministic; the tile is
// then written to conn once, coalesced. Bound: the ELL arrays are read once
// (8 B per slot), part is gathered (4 B per slot, mostly from L2) and conn
// written once (4 B per entry): n*D*8 + n*k*4 bytes over device memory.
#include "common.cuh"

__global__ void partition_gain_kernel(const int* __restrict__ part,
                                      const int* __restrict__ nbr_idx,
                                      const float* __restrict__ nbr_w,
                                      float* __restrict__ conn, int n, int d,
                                      int k) {
  extern __shared__ float acc[];
  const int ks = k | 1;
  const int rows = blockDim.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  for (int i = threadIdx.x; i < rows * ks; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  const long long v = row0 + threadIdx.x;
  if (v < n) {
    const int* idx = nbr_idx + v * d;
    const float* w = nbr_w + v * d;
    float* mine = acc + threadIdx.x * ks;
    for (int q = 0; q < d; ++q) {
      int u = idx[q];
      if (static_cast<unsigned>(u) < static_cast<unsigned>(n)) {
        int b = part[u];
        if (static_cast<unsigned>(b) < static_cast<unsigned>(k)) mine[b] += w[q];
      }
    }
  }
  __syncthreads();
  long long live = n - row0 < rows ? n - row0 : rows;
  for (long long i = threadIdx.x; i < live * k; i += blockDim.x) {
    long long r = i / k;
    conn[row0 * k + i] = acc[r * ks + (i - r * k)];
  }
}

REPRO_EXPORT int partition_gain_launch(const void* part, const void* nbr_idx,
                                       const void* nbr_w, void* conn, int n,
                                       int d, int k, int rows_per_block,
                                       void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  int blocks = (n + rows_per_block - 1) / rows_per_block;
  size_t smem = static_cast<size_t>(rows_per_block) * (k | 1) * sizeof(float);
  partition_gain_kernel<<<blocks, rows_per_block, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(part), static_cast<const int*>(nbr_idx),
      static_cast<const float*>(nbr_w), static_cast<float*>(conn), n, d, k);
  return static_cast<int>(cudaGetLastError());
}
