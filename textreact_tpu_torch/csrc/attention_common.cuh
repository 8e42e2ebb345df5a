// Shared by the attention kernels (attention_fwd.cuh, attention_bwd.cuh)
// and their four sources (fused_attention.cu, fused_attention_bwd.cu,
// causal_attention.cu, causal_attention_bwd.cu): dtype conversions and the
// dispatch over head dim and dropout. The sources are separate libraries so
// that their many unrolled kernel variants compile side by side.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kBQ = 128;   // forward: query rows per block, one per thread
constexpr int kBK = 32;    // forward: keys per shared-memory tile
constexpr float kMaskBias = -1e9f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

using tr::Dropout;
using tr::make_dropout;

// Four neighbouring elements as one 16-byte (f32) or 8-byte (bf16) access.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

#define TR_DISPATCH(CALL)                                                      \
  do {                                                                         \
    if (D == 64) {                                                             \
      if (dropout) CALL(64, true) else CALL(64, false)                         \
    } else if (D == 32) {                                                      \
      if (dropout) CALL(32, true) else CALL(32, false)                         \
    } else {                                                                   \
      return cudaErrorInvalidValue;                                            \
    }                                                                          \
  } while (0)

}  // namespace
