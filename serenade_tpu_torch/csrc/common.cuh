// Shared helpers of the port's CUDA kernels: element conversion between
// the storage type (float or bf16) and the f32 compute type, bf16 pairs,
// and the dispatch from the wrapper's dtype code (0 = float32, 1 =
// bfloat16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace serenade {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float lrelu(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

// two floats as a bf16 pair (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace serenade

// Calls BODY with `using T = float` or `using T = __nv_bfloat16`.
#define SERENADE_DISPATCH(code, ...)          \
  do {                                        \
    if ((code) == 0) {                        \
      using T = float;                        \
      __VA_ARGS__                             \
    } else if ((code) == 1) {                 \
      using T = __nv_bfloat16;                \
      __VA_ARGS__                             \
    } else {                                  \
      return (int)cudaErrorInvalidValue;      \
    }                                         \
  } while (0)
