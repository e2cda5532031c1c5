// Helpers shared by the kernels of moge_tpu_torch/csrc (each .cu builds into
// its own shared library with a plain C interface, loaded with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes passed from Python (ops/_build.py callers).
enum MogeDtype : int { kFloat32 = 0, kBFloat16 = 1 };

// Row padding (elements) that keeps shared-memory rows 16-byte aligned and
// staggers them across banks.
template <typename T> constexpr int kPad = 16 / sizeof(T);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even: the one rounding of the output
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

extern "C" const char* moge_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
