// Residual add + LayerNorm, forward, dropout p = 0, for Hopper (sm_90a).
//
// Replaces: textreact_tpu/ops/fused_layernorm.py::_fwd_kernel (Pallas TPU),
// out = LN(x + y) over the last axis with flax fast-variance numerics:
// f32 statistics, var = E[z^2] - E[z]^2 clamped at 0, eps inside the rsqrt,
// output in the input dtype. Mean and rstd are not written: they serve
// only the backward, which comes with training.
//
// Bound: device memory. Per row the kernel reads x and y and writes out
// (3 * H elements) against ~6 flops per element, far below the card's
// ~295 flop/byte balance point, so the floor is the time to move those
// bytes at 3.35 TB/s.
//
// Design: one warp per row, the whole row held in registers (H / 32 values
// per lane), so z = x + y is formed once and every byte crosses device
// memory exactly once: one read of x and y, one write of out. The two
// sums are reduced with warp shuffles in a single pass; nothing goes
// through shared memory and no block-level barrier is needed. Lanes read
// neighbouring elements, so each warp access is one contiguous segment.
// The TPU kernel's small-row fallback (a Mosaic tiling rule) has no
// counterpart: any row count works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // rows per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int H>
__global__ void __launch_bounds__(kWarps * 32)
residual_layernorm_fwd(const T* __restrict__ x, const T* __restrict__ y,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out,
                       int64_t rows, float eps) {
  constexpr int N = H / 32;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * H;
  const T* yr = y + row * H;

  float z[N];
  float sum = 0.f, sumsq = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = lane + 32 * i;
    const float v = to_f32(xr[c]) + to_f32(yr[c]);
    z[i] = v;
    sum += v;
    sumsq += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sumsq += __shfl_xor_sync(0xffffffffu, sumsq, off);
  }
  const float mean = sum / H;
  const float var = fmaxf(sumsq / H - mean * mean, 0.f);
  const float rstd = 1.f / sqrtf(var + eps);

  T* orow = out + row * H;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = lane + 32 * i;
    const float xhat = (z[i] - mean) * rstd;
    orow[c] = from_f32<T>(xhat * scale[c] + bias[c]);
  }
}

template <typename T>
cudaError_t launch(int hidden, const void* x, const void* y, const float* scale,
                   const float* bias, void* out, int64_t rows, float eps,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  switch (hidden) {
#define TR_CASE(HV)                                                            \
  case HV:                                                                     \
    residual_layernorm_fwd<T, HV><<<grid, block, 0, stream>>>(                 \
        xt, yt, scale, bias, ot, rows, eps);                                   \
    break;
    TR_CASE(128)
    TR_CASE(256)
    TR_CASE(384)
    TR_CASE(512)
    TR_CASE(768)
    TR_CASE(1024)
#undef TR_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x, y, out: (rows, hidden) contiguous;
// scale, bias: (hidden,) float32. Returns cudaGetLastError() after launch.
int tr_residual_layernorm_fwd(int dtype, const void* x, const void* y,
                              const void* scale, const void* bias, void* out,
                              int64_t rows, int hidden, float eps,
                              void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (dtype == 0) return launch<float>(hidden, x, y, s, b, out, rows, eps, st);
  if (dtype == 1) return launch<__nv_bfloat16>(hidden, x, y, s, b, out, rows, eps, st);
  return cudaErrorInvalidValue;
}

const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
