// Shared by the partitioner kernels: a plain C interface for ctypes.
//
// Every entry point takes raw device pointers, sizes and the CUDA stream the
// caller (a PyTorch wrapper) launches on, enqueues its kernel(s) and returns
// cudaGetLastError() as an int, so a refused launch (too many threads, too
// much shared memory) is reported to the wrapper, which raises on nonzero.
// Nothing here allocates or synchronises: the wrapper owns every buffer.
#pragma once

#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

static inline int repro_blocks_for(long long work, int threads, int cap) {
  long long b = (work + threads - 1) / threads;
  if (b < 1) b = 1;
  return static_cast<int>(b < cap ? b : cap);
}
