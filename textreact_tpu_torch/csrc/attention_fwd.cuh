// The attention forward kernel, shared by fused_attention.cu (non-causal,
// with and without dropout) and causal_attention.cu (causal, no dropout).
// What it computes, its bound and its design are set out at the head of
// fused_attention.cu; the causal variant's at the head of
// causal_attention.cu. The two sources are separate libraries so that their
// unrolled variants compile side by side.

#pragma once

#include "attention_common.cuh"

namespace {

// kCausal: query row i sees keys 0 .. i only. The block of query rows
// q0 .. q0 + kBQ - 1 then streams the key tiles below q0 + kBQ and no
// others; inside the tiles that cross the diagonal a key above the row gets
// the score -inf, so its weight is exactly 0 (every row sees key 0, so the
// running max is finite from the first tile on). The key mask stays the
// additive -1e9 of the non-causal kernel.
template <typename T, int D, bool kDrop, bool kCausal>
__global__ void __launch_bounds__(kBQ)
attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int32_t* __restrict__ mask,
              T* __restrict__ out, float2* __restrict__ stats, Dropout drop,
              int L, int H, float scale) {
  __shared__ __align__(16) float ks[kBK][D];
  __shared__ __align__(16) float vs[kBK][D];
  __shared__ float kbias[kBK];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row_i = blockIdx.x * kBQ + threadIdx.x;
  const int64_t row = row_i;
  const int64_t HD = (int64_t)H * D;
  const int64_t head = (int64_t)b * L * HD + (int64_t)h * D;
  const uint32_t bh = (uint32_t)(b * H + h);
  const uint64_t seed = kDrop ? (uint64_t)*drop.seed : 0;
  // one past the last key this block of rows can see
  const int k_end = kCausal ? (int)(blockIdx.x + 1) * kBQ : L;

  float qr[D];
  float acc[D];
  const T* qp = q + head + row * HD;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = to_f32(qp[d]);
    acc[d] = 0.f;
  }
  float m = -INFINITY;  // running row max
  float l = 0.f;        // running softmax normaliser (undropped weights)

#pragma unroll 1
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kBK * D; i += kBQ) {
      const int j = i / D;
      const int d = i % D;
      const int64_t off = head + (int64_t)(k0 + j) * HD + d;
      ks[j][d] = to_f32(k[off]);
      vs[j][d] = to_f32(v[off]);
    }
    if (threadIdx.x < kBK) {
      const bool valid = mask == nullptr || mask[(int64_t)b * L + k0 + threadIdx.x] > 0;
      kbias[threadIdx.x] = valid ? 0.f : kMaskBias;
    }
    __syncthreads();

    float s[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) s[j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(&ks[j][d]);
        s[j] = fmaf(qr[d], kv.x, s[j]);
        s[j] = fmaf(qr[d + 1], kv.y, s[j]);
        s[j] = fmaf(qr[d + 2], kv.z, s[j]);
        s[j] = fmaf(qr[d + 3], kv.w, s[j]);
      }
    }
    float mt = m;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = s[j] * scale + kbias[j];
      if (kCausal && k0 + j > row_i) s[j] = -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float corr = expf(m - mt);  // 0 on the first tile (m = -inf)
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
    uint32_t bits[4];
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float p = expf(s[j] - mt);
      l += p;
      if (kDrop) {
        if ((j & 3) == 0) {
          tr::attention_bits(seed, bh, (uint32_t)row_i, (uint32_t)((k0 + j) >> 2), bits);
        }
        if (bits[j & 3] < drop.threshold) p = 0.f;
      }
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = mt;
  }

  const float r = (kDrop ? drop.inv_keep : 1.f) / l;
  T* op = out + head + row * HD;
#pragma unroll
  for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d] * r);
  if (stats != nullptr) stats[((int64_t)bh) * L + row] = make_float2(m, l);
}

template <typename T, int D, bool kDrop, bool kCausal>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int32_t* mask, void* out, void* stats,
                       Dropout drop, int B, int L, int H, float scale,
                       cudaStream_t stream) {
  attention_fwd<T, D, kDrop, kCausal><<<dim3(L / kBQ, H, B), kBQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out),
      static_cast<float2*>(stats), drop, L, H, scale);
  return cudaGetLastError();
}

}  // namespace
