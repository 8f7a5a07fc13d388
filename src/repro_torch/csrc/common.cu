// The one export shared by every entry point of the kernel library.
#include "common.cuh"

// Error text for a code returned by any *_launch entry point.
REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
