// The text of a CUDA error code, for the Python launchers' messages.

#include <cuda_runtime.h>

extern "C" const char* step_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
