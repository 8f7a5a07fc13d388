// Shared by the partitioner kernels: a plain C interface for ctypes.
//
// Every entry point takes raw device pointers, sizes and the CUDA stream the
// caller (a PyTorch wrapper) launches on, enqueues its kernel(s) and returns
// cudaGetLastError() as an int, so a refused launch (too many threads, too
// much shared memory) is reported to the wrapper, which raises on nonzero.
// Nothing here allocates or synchronises: the wrapper owns every buffer.
#pragma once

#include <cuda_runtime.h>

#include <cstring>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Every *_launch entry point takes its launch from the caller's plan
// (kernels/plan.py): grid and block dims and dynamic shared memory, after
// its own arguments and before the stream. It computes none of them and
// clips none: a plan that disagrees with the kernel's compile-time
// constants is refused with cudaErrorInvalidConfiguration, and one the card
// cannot hold is refused by the launch itself.
struct ReproLaunch {
  dim3 grid, block;
  size_t smem;
};

// The launch, or false where a dim is below 1, the block has more than
// `max_threads` threads (the kernel's __launch_bounds__) or the shared
// memory is negative.
static inline bool repro_launch_dims(int gx, int gy, int gz, int bx, int by,
                                     int bz, long long smem, int max_threads,
                                     ReproLaunch* out) {
  if (gx < 1 || gy < 1 || gz < 1 || bx < 1 || by < 1 || bz < 1 || smem < 0)
    return false;
  if (static_cast<long long>(bx) * by * bz > max_threads) return false;
  out->grid = dim3(gx, gy, gz);
  out->block = dim3(bx, by, bz);
  out->smem = static_cast<size_t>(smem);
  return true;
}

// A failed runtime call's code, its error cleared from the thread's last
// error, so that the next launch's cudaGetLastError() does not report it.
static inline int repro_fail(cudaError_t e) {
  cudaGetLastError();
  return static_cast<int>(e);
}

// The shared-memory opt-in a launch above 48 KB needs.
template <typename K>
static inline cudaError_t repro_smem_optin(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

#define REPRO_LAUNCH_PARAMS                                                 \
  int gx, int gy, int gz, int bx, int by, int bz, long long smem_bytes,     \
      void *stream
#define REPRO_BAD_LAUNCH static_cast<int>(cudaErrorInvalidConfiguration)
