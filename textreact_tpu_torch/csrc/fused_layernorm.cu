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
// point, so the floor is the time to move those bytes. PyTorch's own
// elementwise kernels over the same bytes reach 77% of it on an H100
// (`torch.add(x, y)` at 16384 x 768 bf16: 29.3 us against 22.6;
// scripts/torch_port/layernorm_sweep.py prints both), which is what these
// kernels can expect; with dropout, the Philox words (10 rounds of two
// 32-bit multiplies each, a word an element) add instruction issue on top.
//
// Design. A row belongs to a group of threads: a warp up to 1024 columns
// (the register route, the width a constant of the kernel), a block of
// kWideThreads above, up to 8192 (the wide route, the width a run-time
// value). Thread t of a group holds chunks of V = 16 / sizeof(T)
// neighbouring columns, V * (t + TPR * i) for i < N, so every access is 16
// bytes a thread and a warp's is one contiguous 512-byte segment; a thread
// holds at most 32 columns at every width. A bf16 chunk of eight columns
// takes two Philox calls (philox.cuh, counters column / 4 and column / 4 +
// 1), an f32 chunk one: the bits do not depend on the layout, and
// `keep_mask` exports them. A row's loads, scale and bias (and in the
// backward mean and rstd) are issued before any of them is used, so no
// load waits on the row's reduction.
//
// The forward gives each group one row and launches a block for every
// kFwdWarps rows: the block scheduler keeps the rows in flight. Kernels
// that walked rows in a grid of resident blocks, keeping the next row in
// flight in registers or in a shared-memory ring filled by the TMA's bulk
// copy (cp.async.bulk, an mbarrier a stage), were slower at every shape
// timed (PERF.md's kernel table): they hold fewer warps an SM, and the
// dropout's Philox work then shows.
//
// The backward runs as many blocks as the card holds at once (the wrapper
// sizes the grid from cudaOccupancyMaxActiveBlocksPerMultiprocessor x the
// SMs; tr_residual_layernorm_bwd_plan), each group walking rows group,
// group + groups in the grid, ..., and keeping the column sums of g * xhat
// and g of its columns in registers; a block adds its warps' in shared
// memory in warp order and writes one row of a (nblocks, 2, H) f32
// workspace. The same launch then sums the workspace, with no float
// atomics: the last `split` blocks to finish (an integer counter) wait
// until every block has written its row and each sums a slice of the
// columns over all rows in row order (split_column_sums). The order of
// every sum is fixed by the grid, never by which block finishes first, so
// a backward gives the same bits on every run; the counters are left at
// 0, so the wrapper's zeroed pair (one per device and stream) serves every
// later call, a CUDA graph's too.
//
// The TPU kernel's small-row fallback (a Mosaic tiling rule) has no
// counterpart: any row count from 1 works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

namespace {

constexpr int kFwdWarps = 4;        // rows a forward block of the register route holds
constexpr int kBwdThreads = 256;    // a backward block, on either route
constexpr int kBwdWarps = kBwdThreads / 32;  // its rows at once on the register route
constexpr int kWideThreads = 256;   // a row's threads on the wide route
constexpr int kMaxHidden = 8192;

using tr::Dropout;
using tr::make_dropout;

// columns a 16-byte access holds
template <typename T>
struct Cols {
  static constexpr int V = 16 / (int)sizeof(T);
};

__device__ __forceinline__ void unpack(uint4 r, float (&o)[4]) {
  o[0] = __uint_as_float(r.x);
  o[1] = __uint_as_float(r.y);
  o[2] = __uint_as_float(r.z);
  o[3] = __uint_as_float(r.w);
}
// eight bf16, the first in the low half of r.x
__device__ __forceinline__ void unpack(uint4 r, float (&o)[8]) {
  o[0] = __uint_as_float(r.x << 16);
  o[1] = __uint_as_float(r.x & 0xffff0000u);
  o[2] = __uint_as_float(r.y << 16);
  o[3] = __uint_as_float(r.y & 0xffff0000u);
  o[4] = __uint_as_float(r.z << 16);
  o[5] = __uint_as_float(r.z & 0xffff0000u);
  o[6] = __uint_as_float(r.w << 16);
  o[7] = __uint_as_float(r.w & 0xffff0000u);
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]), bf16x2(v[4], v[5]),
                    bf16x2(v[6], v[7]));
}

// V f32 values from p (16-byte aligned)
template <int V>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float* o) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    o[4 * q] = v.x;
    o[4 * q + 1] = v.y;
    o[4 * q + 2] = v.z;
    o[4 * q + 3] = v.w;
  }
}
template <int V>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    reinterpret_cast<float4*>(p)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// bit e: column c + e of `row` kept, for the V columns from c (c % 4 == 0)
template <int V>
__device__ __forceinline__ uint32_t keep_bits(uint64_t seed, int64_t row, int c,
                                              uint32_t threshold) {
  uint32_t keep = 0;
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    uint32_t bits[4];
    tr::row_bits(seed, (uint64_t)row, (uint32_t)((c >> 2) + q), bits);
#pragma unroll
    for (int e = 0; e < 4; ++e) keep |= (uint32_t)(bits[e] >= threshold) << (4 * q + e);
  }
  return keep;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// a and b summed over the row's group (every thread gets the sums), in a
// fixed order: each warp's shuffle, then on the wide route the warps'
// partials in warp order. `red` alternates between calls, so one barrier a
// call suffices: a warp writes red again only after the next call's
// barrier, which every thread reaches after reading this one.
template <int TPR>
__device__ __forceinline__ void group_sum2(float& a, float& b, float (&red)[2][TPR / 32]) {
  a = warp_sum(a);
  b = warp_sum(b);
  if constexpr (TPR > 32) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      red[0][warp] = a;
      red[1][warp] = b;
    }
    __syncthreads();
    a = 0.f;
    b = 0.f;
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
  }
}

// ---- kernels ---------------------------------------------------------------

// this thread's chunks of one row: raw 16-byte words of x, y (and g), the
// chunks past H left 0
template <typename T, int TPR, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ src, int64_t row, int H, int t,
                                         uint4 (&raw)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = Cols<T>::V * (t + TPR * i);
    raw[i] = c < H ? *reinterpret_cast<const uint4*>(src + row * H + c)
                   : make_uint4(0u, 0u, 0u, 0u);
  }
}

// this thread's chunks of an f32 parameter row (0 past H)
template <typename T, int TPR, int N>
__device__ __forceinline__ void load_params(const float* __restrict__ p, int H, int t,
                                            float (&o)[N * Cols<T>::V]) {
  constexpr int V = Cols<T>::V;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = V * (t + TPR * i);
    if (c < H) {
      load_f32<V>(p + c, o + V * i);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) o[V * i + e] = 0.f;
    }
  }
}

// z = x + dropout(y) of this thread's chunks of `row` (0 past H)
template <typename T, int TPR, int N, bool kDrop>
__device__ __forceinline__ void residual(const uint4 (&xr)[N], const uint4 (&yr)[N],
                                         int64_t row, int H, int t, uint64_t seed,
                                         const Dropout& drop, float (&z)[N * Cols<T>::V]) {
  constexpr int V = Cols<T>::V;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = V * (t + TPR * i);
    float xv[V], yv[V];
    unpack(xr[i], xv);
    unpack(yr[i], yv);
    const uint32_t kb = kDrop && c < H ? keep_bits<V>(seed, row, c, drop.threshold) : 0u;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      z[V * i + e] = kDrop ? __fmaf_rn(yv[e], (kb >> e) & 1u ? drop.inv_keep : 0.f, xv[e])
                           : xv[e] + yv[e];
    }
  }
}

// The forward: a group a row, W rows a block, as many blocks as rows need;
// the block scheduler keeps the rows in flight. The row's loads, scale and
// bias are all issued before the first use of any of them.
template <typename T, int TPR, int W, int N, int HC, bool kDrop>
__global__ void __launch_bounds__(TPR * W)
residual_layernorm_fwd(const T* __restrict__ x, const T* __restrict__ y,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out,
                       float* __restrict__ mean_out, float* __restrict__ rstd_out,
                       Dropout drop, int64_t rows, int width, float eps) {
  constexpr int V = Cols<T>::V;
  const int H = HC > 0 ? HC : width;
  __shared__ float red[2][TPR / 32];
  const int t = threadIdx.x % TPR;
  const int64_t row = (int64_t)blockIdx.x * W + threadIdx.x / TPR;
  if (row >= rows) return;  // a whole group: a block on the wide route
  uint4 xr[N], yr[N];
  load_row<T, TPR, N>(x, row, H, t, xr);
  load_row<T, TPR, N>(y, row, H, t, yr);
  float sv[N * V], bv[N * V];
  load_params<T, TPR, N>(scale, H, t, sv);
  load_params<T, TPR, N>(bias, H, t, bv);
  const uint64_t seed = kDrop ? (uint64_t)*drop.seed : 0;

  float z[N * V];
  residual<T, TPR, N, kDrop>(xr, yr, row, H, t, seed, drop, z);
  float sum = 0.f, sumsq = 0.f;
#pragma unroll
  for (int j = 0; j < N * V; ++j) {
    sum += z[j];
    sumsq += z[j] * z[j];
  }
  group_sum2<TPR>(sum, sumsq, red);
  const float mean = sum / H;
  const float var = fmaxf(sumsq / H - mean * mean, 0.f);
  const float rstd = 1.f / sqrtf(var + eps);

  T* orow = out + row * H;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = V * (t + TPR * i);
    if (c >= H) continue;
    float ov[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int n = V * i + e;
      ov[e] = (z[n] - mean) * rstd * sv[n] + bv[n];
    }
    *reinterpret_cast<uint4*>(orow + c) = pack(ov);
  }
  if (mean_out != nullptr && t == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

constexpr int kSumRows = 8;  // rows a thread of the split loads at once

// Every block calls this after writing its row (blockIdx.x) of ws, gridDim.x
// rows of `width` f32. The last `split` blocks to finish (counted on
// counters[0]) wait until every block has, then each sums one slice of the
// columns over all rows, in row order, into out. counters[1] counts the
// slices done; the last resets both to 0. split <= max(1, gridDim.x / 2):
// when a block starts to wait, at least as many blocks have left as can be
// waiting to start, so a waiting block never holds a place one of them
// needs.
__device__ __forceinline__ void split_column_sums(const float* ws, int* counters, int split,
                                                  float* out, int width) {
  __shared__ int rank;
  __shared__ float4 runs[kBwdThreads];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) rank = atomicAdd(&counters[0], 1);
  __syncthreads();
  const int nblocks = gridDim.x;
  const int slice = rank - (nblocks - split);
  if (slice < 0) return;
  if (threadIdx.x == 0) {
    while (*reinterpret_cast<volatile int*>(counters) < nblocks) __nanosleep(32);
  }
  __syncthreads();
  __threadfence();
  // the slice's float4 columns; each column's rows in `parts` runs of
  // `run` consecutive rows, a (column, run) pair a thread, the runs then
  // added in order (one run a column when the slice is as wide as the block)
  const int cols4 = width / 4;
  const int per = (cols4 + split - 1) / split;
  const int c0 = slice * per;
  const int ncol = cols4 - c0 < per ? cols4 - c0 : per;
  if (ncol > 0) {
    int parts = (int)blockDim.x / ncol < nblocks ? (int)blockDim.x / ncol : nblocks;
    if (parts < 1) parts = 1;
    const int run = (nblocks + parts - 1) / parts;
    for (int k = threadIdx.x; k < ncol * parts; k += blockDim.x) {
      const int col = k % ncol;
      const int p = k / ncol;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      const int r1 = (p + 1) * run < nblocks ? (p + 1) * run : nblocks;
      for (int r = p * run; r < r1; r += kSumRows) {
        float4 v[kSumRows];
#pragma unroll
        for (int u = 0; u < kSumRows; ++u) {
          if (r + u < r1) {
            v[u] = __ldcg(reinterpret_cast<const float4*>(ws + (size_t)(r + u) * width) + c0 +
                          col);
          }
        }
#pragma unroll
        for (int u = 0; u < kSumRows; ++u) {
          if (r + u < r1) {
            acc.x += v[u].x;
            acc.y += v[u].y;
            acc.z += v[u].z;
            acc.w += v[u].w;
          }
        }
      }
      if (parts == 1) {
        reinterpret_cast<float4*>(out)[c0 + col] = acc;
      } else {
        runs[k] = acc;  // k < blockDim.x: ncol * parts <= blockDim.x
      }
    }
    if (parts > 1) {
      __syncthreads();
      if ((int)threadIdx.x < ncol) {
        float4 s = runs[threadIdx.x];
        for (int q = 1; q < parts; ++q) {
          const float4 v = runs[q * ncol + threadIdx.x];
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        reinterpret_cast<float4*>(out)[c0 + threadIdx.x] = s;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(&counters[1], 1) == split - 1) {
    counters[0] = 0;
    counters[1] = 0;
  }
}

// The backward: as many blocks as the card holds at once, each group walking
// rows group, group + groups in the grid, ...; ws: (gridDim.x, 2, H) f32,
// out: (2, H), dscale then dbias
template <typename T, int TPR, int W, int N, int HC, bool kDrop>
__global__ void __launch_bounds__(TPR * W)
residual_layernorm_bwd(const T* __restrict__ x, const T* __restrict__ y,
                       const T* __restrict__ g, const float* __restrict__ scale,
                       const float* __restrict__ mean_in,
                       const float* __restrict__ rstd_in, T* __restrict__ dx,
                       T* __restrict__ dy, float* __restrict__ ws, int* __restrict__ counters,
                       int split, float* __restrict__ dparams, Dropout drop, int64_t rows,
                       int hidden) {
  static_assert(TPR * W == kBwdThreads, "split_column_sums sizes its runs by the block");
  constexpr int V = Cols<T>::V;
  const int H = HC > 0 ? HC : hidden;
  extern __shared__ __align__(16) float part[];  // W > 1: W x 2H, the warps' sums
  __shared__ float red[2][2][TPR / 32];
  const int grp = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int64_t stride = (int64_t)gridDim.x * W;
  float sv[N * V], dsc[N * V], dbi[N * V];  // past H: scale 0, so every sum gets 0
  load_params<T, TPR, N>(scale, H, t, sv);
#pragma unroll
  for (int j = 0; j < N * V; ++j) dsc[j] = dbi[j] = 0.f;
  const uint64_t seed = kDrop ? (uint64_t)*drop.seed : 0;

  int par = 0;
  for (int64_t row = (int64_t)blockIdx.x * W + grp; row < rows; row += stride, par ^= 1) {
    uint4 xr[N], yr[N], gr[N];
    load_row<T, TPR, N>(x, row, H, t, xr);
    load_row<T, TPR, N>(y, row, H, t, yr);
    load_row<T, TPR, N>(g, row, H, t, gr);
    const float mean = mean_in[row];
    const float rstd = rstd_in[row];
    // each element's terms right after its Philox word
    float xh[N * V], gv[N * V];
    uint32_t keep = 0;  // bit V * i + e: column V * (t + TPR * i) + e kept
    float hsum = 0.f, hxsum = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = V * (t + TPR * i);
      float xv[V], yv[V], gg[V];
      unpack(xr[i], xv);
      unpack(yr[i], yv);
      unpack(gr[i], gg);
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        uint32_t bits[4] = {0u, 0u, 0u, 0u};
        if (kDrop && c < H) tr::row_bits(seed, (uint64_t)row, (uint32_t)((c >> 2) + q), bits);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 4 * q + e;
          const int n = V * i + m;
          const bool kept = bits[e] >= drop.threshold;
          keep |= (uint32_t)kept << n;
          const float z = kDrop ? __fmaf_rn(yv[m], kept ? drop.inv_keep : 0.f, xv[m])
                                : xv[m] + yv[m];
          xh[n] = (z - mean) * rstd;
          gv[n] = gg[m];
          const float gi = gg[m] * sv[n];
          hsum += gi;
          hxsum += gi * xh[n];
          dsc[n] += gg[m] * xh[n];
          dbi[n] += gg[m];
        }
      }
    }
    group_sum2<TPR>(hsum, hxsum, red[par]);
    const float hm = hsum / H;
    const float hx = hxsum / H;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = V * (t + TPR * i);
      if (c >= H) continue;
      float dxv[V], dyv[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int n = V * i + e;
        const float dz = rstd * (gv[n] * sv[n] - hm - xh[n] * hx);
        dxv[e] = dz;
        dyv[e] = kDrop ? dz * ((keep >> n) & 1u ? drop.inv_keep : 0.f) : dz;
      }
      *reinterpret_cast<uint4*>(dx + row * H + c) = pack(dxv);
      *reinterpret_cast<uint4*>(dy + row * H + c) = pack(dyv);
    }
  }

  // the block's column sums, row blockIdx.x of ws
  const int width = 2 * H;  // of a workspace row
  float* wrow = ws + (size_t)blockIdx.x * width;
  if constexpr (W == 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = V * (t + TPR * i);
      if (c >= H) continue;
      store_f32<V>(wrow + c, dsc + V * i);
      store_f32<V>(wrow + H + c, dbi + V * i);
    }
  } else {
    // the warps' sums through shared memory, added in warp order
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = V * (t + TPR * i);
      if (c >= H) continue;
      store_f32<V>(part + grp * width + c, dsc + V * i);
      store_f32<V>(part + grp * width + H + c, dbi + V * i);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < width; c += TPR * W) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) acc += part[w * width + c];
      wrow[c] = acc;
    }
  }
  split_column_sums(ws, counters, split, dparams, width);
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

// ---- host side -------------------------------------------------------------

struct FwdArgs {
  const void *x, *y;
  const float *scale, *bias;
  void* out;
  float *mean, *rstd;
  Dropout drop;
  int64_t rows;
  int H;
  float eps;
  cudaStream_t stream;
};

struct BwdArgs {
  const void *x, *y, *g;
  const float *scale, *mean, *rstd;
  void *dx, *dy;
  float* ws;
  int* counters;
  int split;
  float* dparams;
  Dropout drop;
  int64_t rows;
  int H;
  int nblocks;
  cudaStream_t stream;
};

template <typename T, int TPR, int W, int N, int HC, bool kDrop>
cudaError_t fwd_one(const FwdArgs& a, int*) {
  const int64_t grid = (a.rows + W - 1) / W;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  residual_layernorm_fwd<T, TPR, W, N, HC, kDrop><<<(unsigned)grid, TPR * W, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.y), a.scale, a.bias,
      static_cast<T*>(a.out), a.mean, a.rstd, a.drop, a.rows, a.H, a.eps);
  return cudaGetLastError();
}

// The backward's plan on the current device: plan[0] rows a block holds at
// once, plan[1] blocks an SM holds at once. Rows of every width of an
// instantiation share its shared-memory limit, so the limit set is that of
// its widest rows.
template <typename T, int TPR, int W, int N, int HC, bool kDrop>
cudaError_t bwd_one(const BwdArgs& a, int* plan) {
  auto kernel = residual_layernorm_bwd<T, TPR, W, N, HC, kDrop>;
  const int smem = W > 1 ? W * 2 * a.H * (int)sizeof(float) : 0;
  if (plan != nullptr) {
    const int smem_max = W > 1 ? W * 2 * N * TPR * Cols<T>::V * (int)sizeof(float) : 0;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, TPR * W, smem);
    if (err != cudaSuccess) return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    plan[0] = W;
    plan[1] = blocks;
    return cudaSuccess;
  }
  if (a.nblocks < 1 || a.split < 1 || a.split > (a.nblocks > 1 ? a.nblocks / 2 : 1)) {
    return cudaErrorInvalidValue;
  }
  kernel<<<a.nblocks, TPR * W, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.y), static_cast<const T*>(a.g),
      a.scale, a.mean, a.rstd, static_cast<T*>(a.dx), static_cast<T*>(a.dy), a.ws,
      a.counters, a.split, a.dparams, a.drop, a.rows, a.H);
  return cudaGetLastError();
}

template <typename T, int TPR, int W, int N, int HC>
cudaError_t run_n(const FwdArgs& a, bool drop, int* plan) {
  return drop ? fwd_one<T, TPR, W, N, HC, true>(a, plan)
              : fwd_one<T, TPR, W, N, HC, false>(a, plan);
}

template <typename T, int TPR, int W, int N, int HC>
cudaError_t run_n(const BwdArgs& a, bool drop, int* plan) {
  return drop ? bwd_one<T, TPR, W, N, HC, true>(a, plan)
              : bwd_one<T, TPR, W, N, HC, false>(a, plan);
}

// the register route: a warp a row, the width a constant of the kernel
template <typename T, int W, int HC, typename Args>
cudaError_t run_width(const Args& a, bool drop, int* plan) {
  constexpr int N = (HC + 32 * Cols<T>::V - 1) / (32 * Cols<T>::V);
  return run_n<T, 32, W, N, HC>(a, drop, plan);
}

// the wide route: a block a row, the width a run-time value of at most N
// chunks a thread, N = ceil(H / (kWideThreads * V)) <= 32 / V
template <typename T, typename Args>
cudaError_t run_wide(const Args& a, bool drop, int* plan) {
  constexpr int V = Cols<T>::V;
  constexpr int kCols = kWideThreads * V;
  switch ((a.H + kCols - 1) / kCols) {
    case 1: return run_n<T, kWideThreads, 1, 1, 0>(a, drop, plan);
    case 2: return run_n<T, kWideThreads, 1, 2, 0>(a, drop, plan);
    case 3: return run_n<T, kWideThreads, 1, 3, 0>(a, drop, plan);
    case 4: return run_n<T, kWideThreads, 1, 4, 0>(a, drop, plan);
    default: break;
  }
  if constexpr (V == 4) {
    switch ((a.H + kCols - 1) / kCols) {
      case 5: return run_n<T, kWideThreads, 1, 5, 0>(a, drop, plan);
      case 6: return run_n<T, kWideThreads, 1, 6, 0>(a, drop, plan);
      case 7: return run_n<T, kWideThreads, 1, 7, 0>(a, drop, plan);
      case 8: return run_n<T, kWideThreads, 1, 8, 0>(a, drop, plan);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

// the route of H: a warp a row up to 1024, a block above
template <typename T, typename Args>
cudaError_t run(const Args& a, bool drop, int* plan) {
  constexpr int W = std::is_same<Args, BwdArgs>::value ? kBwdWarps : kFwdWarps;
  if (a.H <= 0 || a.H % 128 != 0 || a.H > kMaxHidden) return cudaErrorInvalidValue;
  switch (a.H) {
    case 128: return run_width<T, W, 128>(a, drop, plan);
    case 256: return run_width<T, W, 256>(a, drop, plan);
    case 384: return run_width<T, W, 384>(a, drop, plan);
    case 512: return run_width<T, W, 512>(a, drop, plan);
    case 640: return run_width<T, W, 640>(a, drop, plan);
    case 768: return run_width<T, W, 768>(a, drop, plan);
    case 896: return run_width<T, W, 896>(a, drop, plan);
    case 1024: return run_width<T, W, 1024>(a, drop, plan);
    default: return run_wide<T>(a, drop, plan);
  }
}

template <typename Args>
cudaError_t run_dtype(int dtype, const Args& a, bool drop, int* plan) {
  if (dtype == 0) return run<float>(a, drop, plan);
  if (dtype == 1) return run<__nv_bfloat16>(a, drop, plan);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Conventions of every entry point. dtype: 0 = float32, 1 = bfloat16.
// x, y, out, g, dx, dy: (rows, hidden) contiguous, 16-byte aligned; scale,
// bias: (hidden,) float32; mean, rstd: (rows,) float32 (null in the forward
// when no gradient is needed); seed: one int64 in device memory, or null for
// no dropout; threshold and inv_keep as in philox.cuh. Returns
// cudaGetLastError() after the launch.

// The backward kernel's plan on the current device: plan[0] rows a block
// holds at once, plan[1] blocks an SM holds at once (occupancy). Sets the
// kernel's shared-memory limit, so call it before the kernel's first launch
// on a device.
int tr_residual_layernorm_bwd_plan(int dtype, int hidden, int drop, int* plan) {
  BwdArgs a{};
  a.H = hidden;
  return run_dtype(dtype, a, drop != 0, plan);
}

int tr_residual_layernorm_fwd(int dtype, const void* x, const void* y,
                              const void* scale, const void* bias, void* out,
                              void* mean, void* rstd, const void* seed,
                              uint32_t threshold, float inv_keep, int64_t rows,
                              int hidden, float eps, void* stream) {
  if (rows == 0) return 0;
  FwdArgs a;
  a.x = x;
  a.y = y;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.mean = static_cast<float*>(mean);
  a.rstd = static_cast<float*>(rstd);
  a.drop = make_dropout(seed, threshold, inv_keep);
  a.rows = rows;
  a.H = hidden;
  a.eps = eps;
  a.stream = static_cast<cudaStream_t>(stream);
  return run_dtype(dtype, a, seed != nullptr, nullptr);
}

// nblocks: the grid, at most the plan's blocks an SM times the SMs; ws:
// (nblocks, 2, hidden) float32 workspace; counters: two int32, both 0 (and
// left 0); split: the blocks that sum the workspace's columns, 1 <= split
// <= max(1, nblocks / 2); dparams: (2, hidden) float32, row 0 = dscale, row
// 1 = dbias.
int tr_residual_layernorm_bwd(int dtype, const void* x, const void* y,
                              const void* g, const void* scale, const void* mean,
                              const void* rstd, void* dx, void* dy, void* ws,
                              void* counters, int nblocks, int split, void* dparams,
                              const void* seed, uint32_t threshold, float inv_keep,
                              int64_t rows, int hidden, void* stream) {
  BwdArgs a;
  a.x = x;
  a.y = y;
  a.g = g;
  a.scale = static_cast<const float*>(scale);
  a.mean = static_cast<const float*>(mean);
  a.rstd = static_cast<const float*>(rstd);
  a.dx = dx;
  a.dy = dy;
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.split = split;
  a.dparams = static_cast<float*>(dparams);
  a.drop = make_dropout(seed, threshold, inv_keep);
  a.rows = rows;
  a.H = hidden;
  a.nblocks = nblocks;
  a.stream = static_cast<cudaStream_t>(stream);
  return run_dtype(dtype, a, seed != nullptr, nullptr);
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
