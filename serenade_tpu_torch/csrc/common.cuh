// Shared helpers of the port's CUDA kernels: element conversion between
// the storage type (float or bf16) and the f32 compute type, the bf16
// tensor-core primitives (mma.sync, ldmatrix), and the dispatch from the
// wrapper's dtype code (0 = float32, 1 = bfloat16).
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

// D += A B for one m16n8k16 tile: A 16x16 bf16 row-major (4 registers),
// B 16x8 bf16 column-major (2 registers), D 16x8 f32.  Thread (g, t) =
// (lane / 4, lane % 4) holds D rows g and g + 8, columns 2t and 2t + 1.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed on the way to registers.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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
