// The library's two utility entry points: the message of a cudaError_t
// returned by one of the C entry points, for the Python wrappers' error
// text (paddle_tpu_torch/kernels/_build.py), and an empty kernel, whose
// launch through the same ctypes path, timed back to back, is the floor
// under every kernel's time (_build.launch_empty).
#include <cuda_runtime.h>

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int ptt_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
