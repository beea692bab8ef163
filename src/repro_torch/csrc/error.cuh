// The message of a CUDA error code, for the Python wrappers' exceptions,
// and the one place a kernel's dynamic shared memory cap is set.
#pragma once
#include <mutex>
#include <set>
#include <utility>
#include <cuda_runtime.h>

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Opens `kernel`'s dynamic shared memory to the most the current device
// allows (its opt-in limit less the kernel's static shared memory), once
// per kernel and device in the process, under a lock; a launch asking for
// more still fails. Serving threads launch the same kernel at once (a
// dispatcher beside a canary on another stream): a cap written before
// every launch, at that launch's size, could land between another
// thread's write and its launch, which then failed with "too many
// resources requested for launch".
static cudaError_t open_dynamic_smem(const void* kernel) {
  static std::mutex mu;
  static std::set<std::pair<int, const void*>> opened;
  std::lock_guard<std::mutex> lock(mu);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || opened.count({dev, kernel})) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)fa.sharedSizeBytes);
  if (err == cudaSuccess) opened.insert({dev, kernel});
  return err;
}
