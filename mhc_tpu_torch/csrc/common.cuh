// Shared by the port's kernel libraries: each csrc/<name>.cu is built into
// its own shared library (ops/kernels/_build.py), so this header is
// compiled once per library.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

extern "C" const char* mhc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Streaming multiprocessors of the current device (sizes persistent grids).
static inline int mhc_num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

__device__ __forceinline__ int64_t mhc_clamp(int64_t v, int64_t lo,
                                             int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
