// Shared by the attention kernels (attention_fwd.cuh, attention_bwd.cuh,
// attention_mma.cuh) and their four sources (fused_attention.cu,
// fused_attention_bwd.cu, causal_attention.cu, causal_attention_bwd.cu): the
// mask bias, the exact (float32) kernels' tile sizes and accessors, and the
// dispatch over head dim and dropout. The sources are separate libraries so
// that their many unrolled kernel variants compile side by side.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kBQ = 128;   // exact forward: query rows per block, one per thread
constexpr int kBK = 32;    // exact forward: keys per shared-memory tile
constexpr float kMaskBias = -1e9f;

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

using tr::Dropout;
using tr::make_dropout;

// Four neighbouring f32 elements as one 16-byte access (the exact kernels).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

#define TR_DISPATCH(CALL)                                                      \
  do {                                                                         \
    if (D == 64) {                                                             \
      if (dropout) CALL(64, true) else CALL(64, false)                         \
    } else if (D == 128) {                                                     \
      if (dropout) CALL(128, true) else CALL(128, false)                       \
    } else if (D == 32) {                                                      \
      if (dropout) CALL(32, true) else CALL(32, false)                         \
    } else {                                                                   \
      return cudaErrorInvalidValue;                                            \
    }                                                                          \
  } while (0)

}  // namespace
