// Residual add + dropout + LayerNorm, forward and backward, for Hopper
// (sm_90a).
//
// Replaces: textreact_tpu/ops/fused_layernorm.py::_fwd_kernel and
// ::_bwd_kernel (Pallas TPU). Forward: out = LN(x + dropout(y)) over the
// last axis with flax fast-variance numerics: f32 statistics,
// var = E[z^2] - E[z]^2 clamped at 0, eps inside the rsqrt, output in the
// input dtype; mean and rstd are written when the caller needs a gradient.
// Backward: z and the dropout mask are recomputed from x, y and the seed
// (never stored), then with xhat = (z - mean) * rstd and gi = g * scale:
// dz = rstd * (gi - mean(gi) - xhat * mean(gi * xhat)), dx = dz,
// dy = dz * keep / (1 - p), dscale = sum_rows g * xhat, dbias = sum_rows g.
//
// Bound: device memory. The forward reads x and y and writes out (3 * H
// elements a row), the backward reads x, y and g and writes dx and dy
// (5 * H), against a few flops per element, far below the card's balance
// point, so the floor is the time to move those bytes.
//
// Design: one warp per row, the whole row in registers. A lane holds groups
// of four neighbouring columns (4 * lane + 128 * i), so each access is one
// 8- or 16-byte vector, a warp's access is one contiguous segment, and one
// Philox call (philox.cuh, counter = (row, column / 4)) covers a lane's
// group. Sums are reduced with warp shuffles; every byte crosses device
// memory once. The TPU kernel seeds a per-core stream per row block and
// accumulates dscale / dbias across its SEQUENTIAL grid; blocks run in no
// order here and float atomics would make a step irreproducible. So in the
// backward each warp walks a fixed set of rows and keeps its partial column
// sums in registers, a block adds its warps' partials in shared memory in a
// fixed order and writes one (2, H) row of a workspace, and a second small
// kernel sums the workspace's columns, again in a fixed order. The TPU
// kernel's small-row fallback (a Mosaic tiling rule) has no counterpart: any
// row count works. Hidden sizes: every multiple of 128 up to 1024
// (TR_HIDDEN_CASES). A lane's backward holds 24 values a group of four
// columns, 192 registers at 1024, which is where the register file ends; the
// TPU kernel takes larger rows, and a model with one is refused on the card
// before its first batch (models/factory.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kWarps = 4;  // warps (rows in flight) per block

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  out[0] = __low2float(a);
  out[1] = __high2float(a);
  out[2] = __low2float(b);
  out[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, const float in[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float in[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(in[0], in[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(in[2], in[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

using tr::Dropout;
using tr::make_dropout;

// z = x + dropout(y) for one row, this lane's N groups of four columns;
// dmask[i] = keep / (1 - p) per element (1 without dropout).
template <typename T, int H, bool kDrop>
__device__ __forceinline__ void dropped_residual(const T* __restrict__ xr,
                                                 const T* __restrict__ yr,
                                                 int64_t row, int lane, Dropout drop,
                                                 uint64_t seed, float* z,
                                                 float* dmask) {
  constexpr int N = H / 128;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = 4 * lane + 128 * i;
    float xv[4], yv[4];
    load4(xr + c, xv);
    load4(yr + c, yv);
    uint32_t bits[4];
    if (kDrop) tr::row_bits(seed, (uint64_t)row, (uint32_t)(c >> 2), bits);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float dm = 1.f;
      if (kDrop) dm = bits[e] >= drop.threshold ? drop.inv_keep : 0.f;
      z[4 * i + e] = xv[e] + yv[e] * dm;
      if (dmask != nullptr) dmask[4 * i + e] = dm;
    }
  }
}

template <typename T, int H, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
residual_layernorm_fwd(const T* __restrict__ x, const T* __restrict__ y,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out,
                       float* __restrict__ mean_out, float* __restrict__ rstd_out,
                       Dropout drop, int64_t rows, float eps) {
  constexpr int N = H / 128;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint64_t seed = kDrop ? (uint64_t)*drop.seed : 0;

  float z[4 * N];
  dropped_residual<T, H, kDrop>(x + row * H, y + row * H, row, lane, drop, seed, z,
                                nullptr);
  float sum = 0.f, sumsq = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * N; ++i) {
    sum += z[i];
    sumsq += z[i] * z[i];
  }
  sum = warp_sum(sum);
  sumsq = warp_sum(sumsq);
  const float mean = sum / H;
  const float var = fmaxf(sumsq / H - mean * mean, 0.f);
  const float rstd = 1.f / sqrtf(var + eps);

  T* orow = out + row * H;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = 4 * lane + 128 * i;
    float sv[4], bv[4], ov[4];
    load4(scale + c, sv);
    load4(bias + c, bv);
#pragma unroll
    for (int e = 0; e < 4; ++e) ov[e] = (z[4 * i + e] - mean) * rstd * sv[e] + bv[e];
    store4(orow + c, ov);
  }
  if (mean_out != nullptr && lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// partial: (gridDim.x, 2, H) f32; row b holds block b's column sums of
// g * xhat (dscale) and of g (dbias).
template <typename T, int H, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
residual_layernorm_bwd(const T* __restrict__ x, const T* __restrict__ y,
                       const T* __restrict__ g, const float* __restrict__ scale,
                       const float* __restrict__ mean_in,
                       const float* __restrict__ rstd_in, T* __restrict__ dx,
                       T* __restrict__ dy, float* __restrict__ partial,
                       Dropout drop, int64_t rows) {
  constexpr int N = H / 128;
  __shared__ float part[kWarps][2][H];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint64_t seed = kDrop ? (uint64_t)*drop.seed : 0;

  float sv[4 * N];
#pragma unroll
  for (int i = 0; i < N; ++i) load4(scale + 4 * lane + 128 * i, sv + 4 * i);
  float dsc[4 * N], dbi[4 * N];
#pragma unroll
  for (int i = 0; i < 4 * N; ++i) {
    dsc[i] = 0.f;
    dbi[i] = 0.f;
  }

  const int64_t stride = (int64_t)gridDim.x * kWarps;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + warp; row < rows; row += stride) {
    float z[4 * N], dmask[4 * N], gv[4 * N];
    dropped_residual<T, H, kDrop>(x + row * H, y + row * H, row, lane, drop, seed, z,
                                  dmask);
#pragma unroll
    for (int i = 0; i < N; ++i) load4(g + row * H + 4 * lane + 128 * i, gv + 4 * i);
    const float mean = mean_in[row];
    const float rstd = rstd_in[row];
    float hsum = 0.f, hxsum = 0.f;
#pragma unroll
    for (int i = 0; i < 4 * N; ++i) {
      z[i] = (z[i] - mean) * rstd;  // xhat
      const float gi = gv[i] * sv[i];
      hsum += gi;
      hxsum += gi * z[i];
      dsc[i] += gv[i] * z[i];
      dbi[i] += gv[i];
    }
    const float hm = warp_sum(hsum) / H;
    const float hx = warp_sum(hxsum) / H;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = 4 * lane + 128 * i;
      float dxv[4], dyv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * i + e;
        const float dz = rstd * (gv[n] * sv[n] - hm - z[n] * hx);
        dxv[e] = dz;
        dyv[e] = dz * dmask[n];
      }
      store4(dx + row * H + c, dxv);
      store4(dy + row * H + c, dyv);
    }
  }

#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * lane + 128 * i + e;
      part[warp][0][c] = dsc[4 * i + e];
      part[warp][1][c] = dbi[4 * i + e];
    }
  }
  __syncthreads();
  float* prow = partial + (int64_t)blockIdx.x * 2 * H;
  for (int c = threadIdx.x; c < 2 * H; c += kWarps * 32) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += (&part[w][0][0])[c];
    prow[c] = acc;
  }
}

// out[c] = sum over b of partial[b][c], c < width; a block sums 32 columns
// with 32 row slices, each slice and the final sum in a fixed order.
__global__ void __launch_bounds__(1024)
column_sums(const float* __restrict__ partial, float* __restrict__ out, int nrows,
            int width) {
  __shared__ float tile[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (c < width) {
    for (int b = threadIdx.y; b < nrows; b += 32) acc += partial[(int64_t)b * width + c];
  }
  tile[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < width) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) total += tile[r][threadIdx.x];
    out[c] = total;
  }
}

// Test-only: the keep mask of (seed, rows, H), one byte per element.
__global__ void row_keep_mask(const int64_t* __restrict__ seed, uint32_t threshold,
                              uint8_t* __restrict__ out, int64_t rows, int H) {
  const int H4 = H / 4;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * H4) return;
  uint32_t bits[4];
  tr::row_bits((uint64_t)*seed, (uint64_t)(i / H4), (uint32_t)(i % H4), bits);
  uchar4 keep;
  keep.x = bits[0] >= threshold;
  keep.y = bits[1] >= threshold;
  keep.z = bits[2] >= threshold;
  keep.w = bits[3] >= threshold;
  reinterpret_cast<uchar4*>(out)[i] = keep;
}

#define TR_HIDDEN_CASES(CALL)                                                  \
  switch (hidden) {                                                            \
    case 128: CALL(128) break;                                                 \
    case 256: CALL(256) break;                                                 \
    case 384: CALL(384) break;                                                 \
    case 512: CALL(512) break;                                                 \
    case 640: CALL(640) break;                                                 \
    case 768: CALL(768) break;                                                 \
    case 896: CALL(896) break;                                                 \
    case 1024: CALL(1024) break;                                               \
    default: return cudaErrorInvalidValue;                                     \
  }

template <typename T>
cudaError_t fwd(int hidden, const void* x, const void* y, const float* scale,
                const float* bias, void* out, float* mean, float* rstd,
                Dropout drop, int64_t rows, float eps, cudaStream_t stream) {
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
#define TR_FWD(HV)                                                             \
  if (drop.seed != nullptr) {                                                  \
    residual_layernorm_fwd<T, HV, true><<<grid, block, 0, stream>>>(           \
        xt, yt, scale, bias, ot, mean, rstd, drop, rows, eps);                 \
  } else {                                                                     \
    residual_layernorm_fwd<T, HV, false><<<grid, block, 0, stream>>>(          \
        xt, yt, scale, bias, ot, mean, rstd, drop, rows, eps);                 \
  }
  TR_HIDDEN_CASES(TR_FWD)
#undef TR_FWD
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(int hidden, const void* x, const void* y, const void* g,
                const float* scale, const float* mean, const float* rstd, void* dx,
                void* dy, float* partial, int nblocks, float* dparams, Dropout drop,
                int64_t rows, cudaStream_t stream) {
  const dim3 block(kWarps * 32);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  T* dyt = static_cast<T*>(dy);
#define TR_BWD(HV)                                                             \
  if (drop.seed != nullptr) {                                                  \
    residual_layernorm_bwd<T, HV, true><<<nblocks, block, 0, stream>>>(        \
        xt, yt, gt, scale, mean, rstd, dxt, dyt, partial, drop, rows);         \
  } else {                                                                     \
    residual_layernorm_bwd<T, HV, false><<<nblocks, block, 0, stream>>>(       \
        xt, yt, gt, scale, mean, rstd, dxt, dyt, partial, drop, rows);         \
  }
  TR_HIDDEN_CASES(TR_BWD)
#undef TR_BWD
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int width = 2 * hidden;
  column_sums<<<(width + 31) / 32, dim3(32, 32), 0, stream>>>(partial, dparams,
                                                              nblocks, width);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Conventions of every entry point. dtype: 0 = float32, 1 = bfloat16.
// x, y, out, g, dx, dy: (rows, hidden) contiguous, 16-byte aligned; scale,
// bias: (hidden,) float32; mean, rstd: (rows,) float32 (null in the forward
// when no gradient is needed); seed: one int64 in device memory, or null for
// no dropout; threshold and inv_keep as in philox.cuh. Returns
// cudaGetLastError() after the launch.

int tr_residual_layernorm_fwd(int dtype, const void* x, const void* y,
                              const void* scale, const void* bias, void* out,
                              void* mean, void* rstd, const void* seed,
                              uint32_t threshold, float inv_keep, int64_t rows,
                              int hidden, float eps, void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop = make_dropout(seed, threshold, inv_keep);
  if (rows == 0) return 0;
  if (dtype == 0) return fwd<float>(hidden, x, y, s, b, out, mp, rp, drop, rows, eps, st);
  if (dtype == 1) {
    return fwd<__nv_bfloat16>(hidden, x, y, s, b, out, mp, rp, drop, rows, eps, st);
  }
  return cudaErrorInvalidValue;
}

// partial: (nblocks, 2, hidden) float32 workspace; dparams: (2, hidden)
// float32, row 0 = dscale, row 1 = dbias. nblocks >= 1 is the backward
// kernel's grid; each of its warps walks rows warp, warp + 4 * nblocks, ...
int tr_residual_layernorm_bwd(int dtype, const void* x, const void* y,
                              const void* g, const void* scale, const void* mean,
                              const void* rstd, void* dx, void* dy, void* partial,
                              int nblocks, void* dparams, const void* seed,
                              uint32_t threshold, float inv_keep, int64_t rows,
                              int hidden, void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  float* pp = static_cast<float*>(partial);
  float* dp = static_cast<float*>(dparams);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop = make_dropout(seed, threshold, inv_keep);
  if (nblocks < 1) return cudaErrorInvalidValue;
  if (dtype == 0) {
    return bwd<float>(hidden, x, y, g, s, mp, rp, dx, dy, pp, nblocks, dp, drop, rows, st);
  }
  if (dtype == 1) {
    return bwd<__nv_bfloat16>(hidden, x, y, g, s, mp, rp, dx, dy, pp, nblocks, dp, drop,
                              rows, st);
  }
  return cudaErrorInvalidValue;
}

// Test-only: out (rows, hidden) uint8, 1 where the element is kept.
int tr_row_keep_mask(const void* seed, uint32_t threshold, void* out, int64_t rows,
                     int hidden, void* stream) {
  if (hidden % 4 != 0) return cudaErrorInvalidValue;
  const int64_t n = rows * (hidden / 4);
  if (n == 0) return 0;
  const int threads = 256;
  row_keep_mask<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(seed), threshold, static_cast<uint8_t*>(out), rows,
      hidden);
  return cudaGetLastError();
}

const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
