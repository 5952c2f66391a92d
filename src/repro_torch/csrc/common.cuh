// Shared helpers of the port's CUDA sources. Each source in this directory
// is compiled on its own into one shared library with a plain C interface
// (loaded from Python with ctypes), so this header is included once per
// library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed by the Python wrappers
enum { REPRO_F32 = 0, REPRO_BF16 = 1 };

namespace repro {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
// round to nearest even, as torch's and XLA's float32 -> bfloat16 casts
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace repro

// Human-readable text for the code a launch function returned.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
