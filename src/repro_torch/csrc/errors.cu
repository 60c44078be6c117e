// Error text for the codes the kernel entry points return
// (each returns cudaGetLastError() right after its launch).
#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
