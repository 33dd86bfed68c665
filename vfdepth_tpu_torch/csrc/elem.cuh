// Element types of the kernels' tensors: float (an f32 model) or
// __nv_bfloat16 (mixed precision). The kernels' arithmetic is f32 in both
// forms; a bf16 element is widened on load and rounded once (to nearest
// even) on store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 bf16x2_float2(uint32_t bits) {
  __nv_bfloat162 v;
  *reinterpret_cast<uint32_t*>(&v) = bits;
  return __bfloat1622float2(v);
}

// 4 consecutive elements, p aligned to 4 elements
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = bf16x2_float2(u.x), b = bf16x2_float2(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Vector width (4, 2 or 1 elements) usable at `ptr + k * stride` for every
// k, from the stride and the base pointer's alignment.
template <typename T>
inline int vec_width(const T* ptr, int64_t stride) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(ptr);
  if (stride % 4 == 0 && a % (4 * sizeof(T)) == 0) return 4;
  if (stride % 2 == 0 && a % (2 * sizeof(T)) == 0) return 2;
  return 1;
}
