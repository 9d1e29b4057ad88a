// The message for a CUDA error code returned by one of the kernels' C
// entry points (each returns cudaGetLastError() right after its launch).
#include <cuda_runtime.h>

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
