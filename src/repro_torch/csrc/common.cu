// The exports shared by every entry point of the kernel library.
#include "common.cuh"

// Error text for a code returned by any *_launch entry point.
REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blocks of the kernel at `fn` (a <entry>_kernel_of answer) one SM holds at
// `threads` threads and `smem` bytes of dynamic shared memory; the opt-in
// above 48 KB is raised first, as the launchers raise it.
REPRO_EXPORT int repro_occupancy(const void* fn, int threads, long long smem,
                                 int* blocks) {
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidDeviceFunction);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return repro_fail(e);
  }
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, threads, static_cast<size_t>(smem));
  return e == cudaSuccess ? 0 : repro_fail(e);
}

// cudaFuncGetAttributes of the kernel at `fn`: out[0] registers a thread,
// out[1] static shared memory, out[2] the most threads a block, out[3] the
// dynamic shared memory it is allowed now.
REPRO_EXPORT int repro_func_attributes(const void* fn, int* out) {
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidDeviceFunction);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return repro_fail(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = a.maxThreadsPerBlock;
  out[3] = a.maxDynamicSharedSizeBytes;
  return 0;
}
