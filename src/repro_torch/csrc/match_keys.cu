// Jittered, masked heavy-edge matching keys (one match round of
// core/coarsen.py:coarsen_device):
//
//     key[a] = w[a] * (1 + 0.01 * u[a])   if mask[a] > 0   else -1
//
// Replaces the Pallas kernel repro/kernels/match_keys.py:match_keys_tiled.
// Pure streaming map: 12 B read + 4 B written per arc, no reuse, so the card
// is bound by device-memory bytes. One thread per arc, grid-stride, adjacent
// threads on adjacent words (coalesced). The arithmetic uses the _rn
// intrinsics so nvcc cannot contract it into an FMA: the result is then
// bit-identical to the plain PyTorch version (separate mul/add/mul).
#include "common.cuh"

__global__ void match_keys_kernel(const float* __restrict__ w,
                                  const float* __restrict__ u,
                                  const float* __restrict__ mask,
                                  float* __restrict__ out, long long m) {
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long a = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       a < m; a += stride) {
    float jitter = __fadd_rn(1.0f, __fmul_rn(0.01f, u[a]));
    float key = __fmul_rn(w[a], jitter);
    out[a] = mask[a] > 0.0f ? key : -1.0f;
  }
}

REPRO_EXPORT int match_keys_launch(const void* w, const void* u,
                                   const void* mask, void* out, long long m,
                                   int n_sm, void* stream) {
  const int threads = 256;
  int blocks = repro_blocks_for(m, threads, n_sm * 8);
  match_keys_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(mask), static_cast<float*>(out), m);
  return static_cast<int>(cudaGetLastError());
}
