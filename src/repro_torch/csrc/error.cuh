// The message of a CUDA error code, for the Python wrappers' exceptions.
#pragma once
#include <cuda_runtime.h>

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
