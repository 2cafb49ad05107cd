// Shared helpers for the port's CUDA kernels: dtype codes, conversions,
// warp reductions. Kernels take float32 or bfloat16 storage and always
// compute in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nx {

// dtype codes shared with the Python wrappers
enum Dtype : int { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round a float32 value through T and back (the storage type's rounding point)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float load_f32(const void* p, int dtype, size_t i) {
  return dtype == F32 ? static_cast<const float*>(p)[i]
                      : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_f32(void* p, int dtype, size_t i, float v) {
  if (dtype == F32) static_cast<float*>(p)[i] = v;
  else static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
}

// activation codes shared with the Python wrappers (build.ACT_CODES)
enum Act : int { ACT_NONE = 0, ACT_GELU = 1, ACT_QUICK_GELU = 2 };

__device__ __forceinline__ float act_fwd(int act, float v) {
  if (act == ACT_GELU) return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  if (act == ACT_QUICK_GELU) return v / (1.f + expf(-1.702f * v));
  return v;
}

// d act / d a, exact erf GELU (Phi(a) + a phi(a)) or quick_gelu
__device__ __forceinline__ float act_grad(int act, float a) {
  if (act == ACT_GELU) {
    const float cdf = 0.5f * (1.f + erff(a * 0.7071067811865476f));
    const float pdf = expf(-0.5f * a * a) * 0.3989422804014327f;
    return cdf + a * pdf;
  }
  if (act == ACT_QUICK_GELU) {
    const float s = 1.f / (1.f + expf(-1.702f * a));
    return s + 1.702f * a * s * (1.f - s);
  }
  return 1.f;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace nx
