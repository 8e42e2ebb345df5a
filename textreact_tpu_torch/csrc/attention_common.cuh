// Shared by the attention kernels (attention_fwd.cuh, attention_bwd.cuh,
// attention_mma.cuh) and their four sources (fused_attention.cu,
// fused_attention_bwd.cu, causal_attention.cu, causal_attention_bwd.cu): the
// mask bias, the exact (float32) kernels' tile sizes and accessors, and the
// dispatch over the instantiated width and dropout. The sources are separate
// libraries so that their many unrolled kernel variants compile side by side.

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

// The instantiated width W that head dim D runs at: the least of 32, 64 and
// 128 that holds it, for D a multiple of 8; 0 for a head dim the kernels do
// not take (ops/fused_attention.py::kernel_head_dim). The kernels are
// compiled for W and take D at run time: they read and write D columns of
// each head, in rows of H * D, and compute at width W with columns D .. W - 1
// held at zero, which adds exactly nothing to any product.
inline int kernel_width(int D) {
  if (D <= 0 || D % 8 != 0) return 0;
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 0;
}

#define TR_DISPATCH(CALL)                                                      \
  do {                                                                         \
    const int W = kernel_width(D);                                             \
    if (W == 64) {                                                             \
      if (dropout) CALL(64, true) else CALL(64, false)                         \
    } else if (W == 128) {                                                     \
      if (dropout) CALL(128, true) else CALL(128, false)                       \
    } else if (W == 32) {                                                      \
      if (dropout) CALL(32, true) else CALL(32, false)                         \
    } else {                                                                   \
      return cudaErrorInvalidValue;                                            \
    }                                                                          \
  } while (0)

}  // namespace
