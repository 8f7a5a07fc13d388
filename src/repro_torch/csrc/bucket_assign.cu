// Capacity-boundary bucket assignment (core/initial.py:
// initial_partition_device):
//
//     bin[v] = min(#{ i < k-1 : cum[v] >= boundary[i] }, k-1)
//
// Replaces the Pallas kernel repro/kernels/bucket_assign.py:
// bucket_assign_tiled. The k-1 boundaries are read once per block into
// shared memory; every thread then counts its vertex's crossings with the
// same >= comparison loop as the TPU kernel, so the count is exact for any
// boundary order (no binary search, which would need sorted boundaries).
// Traffic is 8 B per vertex plus the boundary row per block; the k-1
// compares per vertex come from shared memory (broadcast, no bank
// conflicts), so at the partitioner's sizes (n ~ 1e4, k <= 512) the kernel
// is bound by launch latency rather than by bytes or operations. The
// wrapper's clip to [0, k-1] is fused into the final store.
#include "common.cuh"

__global__ void bucket_assign_kernel(const float* __restrict__ cum,
                                     const float* __restrict__ bounds,
                                     int* __restrict__ out, long long n,
                                     int n_bounds, int k) {
  extern __shared__ float s_bounds[];
  for (int i = threadIdx.x; i < n_bounds; i += blockDim.x)
    s_bounds[i] = bounds[i];
  __syncthreads();
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < n; v += stride) {
    float c = cum[v];
    int count = 0;
    for (int i = 0; i < n_bounds; ++i) count += (c >= s_bounds[i]) ? 1 : 0;
    out[v] = count < k - 1 ? count : k - 1;
  }
}

REPRO_EXPORT int bucket_assign_launch(const void* cum, const void* bounds,
                                      void* out, long long n, int n_bounds,
                                      int k, int n_sm, void* stream) {
  const int threads = 256;
  int blocks = repro_blocks_for(n, threads, n_sm * 8);
  size_t smem = static_cast<size_t>(n_bounds > 0 ? n_bounds : 1) * sizeof(float);
  bucket_assign_kernel<<<blocks, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cum), static_cast<const float*>(bounds),
      static_cast<int*>(out), n, n_bounds, k);
  return static_cast<int>(cudaGetLastError());
}
