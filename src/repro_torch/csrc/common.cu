// Shared C entry point of the kernels' library: the text of a CUDA error
// code, for the Python wrappers' exceptions.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
