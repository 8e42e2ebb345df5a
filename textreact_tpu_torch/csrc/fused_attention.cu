// Fused non-causal attention, forward, dropout p = 0, for Hopper (sm_90a).
//
// Replaces: textreact_tpu/ops/fused_attention.py::_fwd_kernel (Pallas TPU),
// out = softmax(q k^T * scale + mask_bias) v per (batch, head), where a key
// with mask 0 gets the additive bias -1e9 (not -inf: a row whose keys are
// all masked, as in the collator's dummy rows, stays finite and averages
// v). q, k, v and out stay in the model's (B, L, H * D) activation layout,
// as on the TPU, so no transpose runs around the call.
//
// Bound: at the slice's shape (B=32, L=512, H=12, D=64) a call does
// 4 * B * H * L^2 * D = 25.8 GFLOP against 4 * 25 MB of bf16 q/k/v/out,
// ~1000 flop/byte: compute bound. The TPU kernel keeps a whole (L, L)
// score row block per head in VMEM; on Hopper a 512 x 512 f32 tile per
// head does not fit in a block's 227 KB of shared memory, so the scores are
// never materialised at all.
//
// Design (simple first; tensor cores come later): one block per
// (query tile of 128 rows, head, batch), one thread per query row. A
// thread holds its q row and its f32 output accumulator in registers and
// streams over the keys in tiles of 32 that the block stages, converted to
// f32, in shared memory. Each tile runs an online (streaming) softmax: the
// running row max m and normaliser l are rescaled when the max grows, and
// the final 1/l scales the output once, as the TPU kernel's deferred
// normalisation does. All arithmetic is f32 FMA; every thread of a warp
// reads the same k/v element at a time, so shared-memory reads are
// broadcasts with no bank conflicts, issued as 16-byte vectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;  // query rows per block (one per thread)
constexpr int kBK = 32;   // keys per shared-memory tile
constexpr float kMaskBias = -1e9f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBQ)
attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int32_t* __restrict__ mask,
              T* __restrict__ out, int L, int H, float scale) {
  __shared__ __align__(16) float ks[kBK][D];
  __shared__ __align__(16) float vs[kBK][D];
  __shared__ float kbias[kBK];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int64_t row = (int64_t)blockIdx.x * kBQ + threadIdx.x;
  const int64_t HD = (int64_t)H * D;
  const int64_t head = (int64_t)b * L * HD + (int64_t)h * D;

  float qr[D];
  float acc[D];
  const T* qp = q + head + row * HD;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = to_f32(qp[d]);
    acc[d] = 0.f;
  }
  float m = -INFINITY;  // running row max
  float l = 0.f;        // running softmax normaliser

  for (int k0 = 0; k0 < L; k0 += kBK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kBK * D; i += kBQ) {
      const int j = i / D;
      const int d = i % D;
      const int64_t off = head + (int64_t)(k0 + j) * HD + d;
      ks[j][d] = to_f32(k[off]);
      vs[j][d] = to_f32(v[off]);
    }
    if (threadIdx.x < kBK) {
      const bool keep = mask == nullptr || mask[(int64_t)b * L + k0 + threadIdx.x] > 0;
      kbias[threadIdx.x] = keep ? 0.f : kMaskBias;
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
      mt = fmaxf(mt, s[j]);
    }
    const float corr = expf(m - mt);  // 0 on the first tile (m = -inf)
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - mt);
      l += p;
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

  const float inv = 1.f / l;
  T* op = out + head + row * HD;
#pragma unroll
  for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d] * inv);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* mask, void* out, int B, int L, int H, int D,
                   float scale, cudaStream_t stream) {
  if (L % kBQ != 0 || L % kBK != 0) return cudaErrorInvalidValue;
  const dim3 grid(L / kBQ, H, B);
  const dim3 block(kBQ);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (D == 64) {
    attention_fwd<T, 64><<<grid, block, 0, stream>>>(qt, kt, vt, mask, ot, L, H, scale);
  } else if (D == 32) {
    attention_fwd<T, 32><<<grid, block, 0, stream>>>(qt, kt, vt, mask, ot, L, H, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out: (B, L, H * D) contiguous;
// mask: (B, L) int32 {0, 1} or null. Returns cudaGetLastError() after launch.
int tr_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                     const void* mask, void* out, int B, int L, int H, int D,
                     float scale, void* stream) {
  const int32_t* m = static_cast<const int32_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (dtype == 0) return launch<float>(q, k, v, m, out, B, L, H, D, scale, st);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, m, out, B, L, H, D, scale, st);
  return cudaErrorInvalidValue;
}

const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
