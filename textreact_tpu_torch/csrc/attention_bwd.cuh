// The attention backward kernels (dQ pass, dK/dV pass), shared by
// fused_attention_bwd.cu (non-causal, with and without dropout) and
// causal_attention_bwd.cu (causal, no dropout). What they compute and their
// design are set out at the head of fused_attention_bwd.cu.
//
// kCausal: query row i sees keys 0 .. i only, so p = 0 above the diagonal.
// The dQ pass of a block of rows streams the key tiles below its last row;
// the dK/dV pass of a block of keys streams the query tiles from its first
// key on. Inside the tiles that cross the diagonal the test compares the
// GLOBAL row and column, not the tile's.

#pragma once

#include "attention_common.cuh"


namespace {

constexpr int kThreads = 128;          // threads per block
constexpr int kRows = kThreads / 2;    // rows per block, two threads a row
constexpr int kTile = 32;              // rows of the streamed tile

// Stage `kTile` rows of this head (D elements each, row stride HD) in
// shared memory as f32.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, int64_t HD,
                                           float (*dst)[D], int t) {
  constexpr int C = D / 4;  // groups of four per row
  for (int idx = t; idx < kTile * C; idx += kThreads) {
    const int j = idx / C;
    const int c = idx % C;
    *reinterpret_cast<float4*>(&dst[j][4 * c]) = load4(src + (int64_t)j * HD + 4 * c);
  }
}

__device__ __forceinline__ float pair_sum(float v) {
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

__device__ __forceinline__ float dot4(float4 a, const float* b, float acc) {
  acc = fmaf(a.x, b[0], acc);
  acc = fmaf(a.y, b[1], acc);
  acc = fmaf(a.z, b[2], acc);
  return fmaf(a.w, b[3], acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float* y) {
  y[0] = fmaf(a, x.x, y[0]);
  y[1] = fmaf(a, x.y, y[1]);
  y[2] = fmaf(a, x.z, y[2]);
  y[3] = fmaf(a, x.w, y[3]);
}

// dQ pass; also writes delta = rowsum(dO * O) for the dK/dV pass.
template <typename T, int D, bool kDrop, bool kCausal>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const int32_t* __restrict__ mask,
                 const float2* __restrict__ stats, Dropout drop,
                 T* __restrict__ dq, float* __restrict__ delta, int L, int H,
                 float scale) {
  constexpr int N = D / 8;  // groups of four this thread holds
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];
  __shared__ float kbias[kTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t = threadIdx.x;
  const int half = t & 1;
  const int row = blockIdx.x * kRows + (t >> 1);
  const int64_t HD = (int64_t)H * D;
  const int64_t head = (int64_t)b * L * HD + (int64_t)h * D;
  const int64_t own = head + (int64_t)row * HD;  // this thread's row
  const uint32_t bh = (uint32_t)(b * H + h);
  const uint64_t seed = kDrop ? (uint64_t)*drop.seed : 0;
  const float inv_keep = kDrop ? drop.inv_keep : 1.f;

  float qr[4 * N], gr[4 * N], acc[4 * N];
  float dl = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = 4 * (2 * i + half);
    const float4 qv = load4(q + own + c);
    const float4 gv = load4(dout + own + c);
    const float4 ov = load4(o + own + c);
    qr[4 * i] = qv.x, qr[4 * i + 1] = qv.y, qr[4 * i + 2] = qv.z, qr[4 * i + 3] = qv.w;
    gr[4 * i] = gv.x, gr[4 * i + 1] = gv.y, gr[4 * i + 2] = gv.z, gr[4 * i + 3] = gv.w;
    dl = dot4(ov, gr + 4 * i, dl);
    acc[4 * i] = acc[4 * i + 1] = acc[4 * i + 2] = acc[4 * i + 3] = 0.f;
  }
  dl = pair_sum(dl);
  if (half == 0) delta[(int64_t)bh * L + row] = dl;
  const float2 st = stats[(int64_t)bh * L + row];
  const float m = st.x;
  const float linv = 1.f / st.y;

  // one past the last key this block of rows can see
  const int k_end = kCausal ? (int)(blockIdx.x + 1) * kRows : L;
#pragma unroll 1
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    stage_tile<T, D>(k + head + (int64_t)k0 * HD, HD, ks, t);
    stage_tile<T, D>(v + head + (int64_t)k0 * HD, HD, vs, t);
    if (t < kTile) {
      const bool valid = mask == nullptr || mask[(int64_t)b * L + k0 + t] > 0;
      kbias[t] = valid ? 0.f : kMaskBias;
    }
    __syncthreads();

#pragma unroll 1
    for (int j8 = 0; j8 < kTile; j8 += 8) {
      // bits of keys j8 .. j8 + 7 of this row: each thread of the pair
      // draws four of them
      uint32_t mine[4] = {0u, 0u, 0u, 0u}, theirs[4] = {0u, 0u, 0u, 0u};
      if (kDrop) {
        tr::attention_bits(seed, bh, (uint32_t)row,
                           (uint32_t)((k0 + j8 + 4 * half) >> 2), mine);
#pragma unroll
        for (int w = 0; w < 4; ++w) theirs[w] = __shfl_xor_sync(0xffffffffu, mine[w], 1);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = j8 + jj;
        float s = 0.f, dd = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int c = 4 * (2 * i + half);
          s = dot4(*reinterpret_cast<const float4*>(&ks[j][c]), qr + 4 * i, s);
          dd = dot4(*reinterpret_cast<const float4*>(&vs[j][c]), gr + 4 * i, dd);
        }
        s = pair_sum(s);
        dd = pair_sum(dd);
        // a key above the diagonal has weight 0: global row and column
        const float p = (kCausal && k0 + j > row)
                            ? 0.f : expf(s * scale + kbias[j] - m) * linv;
        float g = dd;
        if (kDrop) {
          // keys j8 .. j8 + 3 were drawn by the pair's thread 0
          const uint32_t bits = ((jj < 4) == (half == 0)) ? mine[jj & 3] : theirs[jj & 3];
          g = bits < drop.threshold ? 0.f : dd * inv_keep;
        }
        const float ds = p * (g - dl) * scale;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int c = 4 * (2 * i + half);
          axpy4(ds, *reinterpret_cast<const float4*>(&ks[j][c]), acc + 4 * i);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = 4 * (2 * i + half);
    store4(dq + own + c,
           make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]));
  }
}

// dK/dV pass; reads the delta that the dQ pass wrote.
template <typename T, int D, bool kDrop, bool kCausal>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const int32_t* __restrict__ mask,
                  const float2* __restrict__ stats,
                  const float* __restrict__ delta, Dropout drop,
                  T* __restrict__ dk, T* __restrict__ dv, int L, int H,
                  float scale) {
  constexpr int N = D / 8;  // groups of four this thread holds
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float dos[kTile][D];
  __shared__ float ms[kTile];      // row max
  __shared__ float linvs[kTile];   // 1 / l
  __shared__ float deltas[kTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t = threadIdx.x;
  const int half = t & 1;
  const int col = blockIdx.x * kRows + (t >> 1);  // this thread's key
  const int64_t HD = (int64_t)H * D;
  const int64_t head = (int64_t)b * L * HD + (int64_t)h * D;
  const int64_t own = head + (int64_t)col * HD;
  const uint32_t bh = (uint32_t)(b * H + h);
  const uint64_t seed = kDrop ? (uint64_t)*drop.seed : 0;
  const float inv_keep = kDrop ? drop.inv_keep : 1.f;
  const float kb = (mask == nullptr || mask[(int64_t)b * L + col] > 0) ? 0.f : kMaskBias;
  const int word = col & 3;  // this key's word of a Philox draw

  float kr[4 * N], vr[4 * N], dka[4 * N], dva[4 * N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = 4 * (2 * i + half);
    const float4 kv = load4(k + own + c);
    const float4 vv = load4(v + own + c);
    kr[4 * i] = kv.x, kr[4 * i + 1] = kv.y, kr[4 * i + 2] = kv.z, kr[4 * i + 3] = kv.w;
    vr[4 * i] = vv.x, vr[4 * i + 1] = vv.y, vr[4 * i + 2] = vv.z, vr[4 * i + 3] = vv.w;
    dka[4 * i] = dka[4 * i + 1] = dka[4 * i + 2] = dka[4 * i + 3] = 0.f;
    dva[4 * i] = dva[4 * i + 1] = dva[4 * i + 2] = dva[4 * i + 3] = 0.f;
  }

  // the first query row that sees this block's keys (a multiple of kTile)
  const int q_begin = kCausal ? (int)blockIdx.x * kRows : 0;
#pragma unroll 1
  for (int q0 = q_begin; q0 < L; q0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    stage_tile<T, D>(q + head + (int64_t)q0 * HD, HD, qs, t);
    stage_tile<T, D>(dout + head + (int64_t)q0 * HD, HD, dos, t);
    if (t < kTile) {
      const float2 st = stats[(int64_t)bh * L + q0 + t];
      ms[t] = st.x;
      linvs[t] = 1.f / st.y;
      deltas[t] = delta[(int64_t)bh * L + q0 + t];
    }
    __syncthreads();

#pragma unroll 1
    for (int i4 = 0; i4 < kTile; i4 += 4) {
      // this key's bit in queries i4 .. i4 + 3: each thread of the pair
      // draws two of them (a draw yields four neighbouring keys' words, of
      // which a key uses one)
      uint32_t mine[2] = {0u, 0u}, theirs[2] = {0u, 0u};
      if (kDrop) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t bits[4];
          tr::attention_bits(seed, bh, (uint32_t)(q0 + i4 + 2 * half + r),
                             (uint32_t)(col >> 2), bits);
          mine[r] = word == 0 ? bits[0] : word == 1 ? bits[1] : word == 2 ? bits[2] : bits[3];
          theirs[r] = __shfl_xor_sync(0xffffffffu, mine[r], 1);
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i4 + ii;
        float s = 0.f, dd = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const int c = 4 * (2 * n + half);
          s = dot4(*reinterpret_cast<const float4*>(&qs[i][c]), kr + 4 * n, s);
          dd = dot4(*reinterpret_cast<const float4*>(&dos[i][c]), vr + 4 * n, dd);
        }
        s = pair_sum(s);
        dd = pair_sum(dd);
        // a query above the diagonal does not see this key: global row
        // and column
        const float p = (kCausal && q0 + i < col)
                            ? 0.f : expf(s * scale + kb - ms[i]) * linvs[i];
        float pd = p;  // dropped, rescaled probability (meets dO in dV)
        float g = dd;
        if (kDrop) {
          // queries i4, i4 + 1 were drawn by the pair's thread 0
          const uint32_t bits = ((ii < 2) == (half == 0)) ? mine[ii & 1] : theirs[ii & 1];
          const bool keep = bits >= drop.threshold;
          pd = keep ? p * inv_keep : 0.f;
          g = keep ? dd * inv_keep : 0.f;
        }
        const float ds = p * (g - deltas[i]) * scale;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const int c = 4 * (2 * n + half);
          axpy4(ds, *reinterpret_cast<const float4*>(&qs[i][c]), dka + 4 * n);
          axpy4(pd, *reinterpret_cast<const float4*>(&dos[i][c]), dva + 4 * n);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = 4 * (2 * i + half);
    store4(dk + own + c,
           make_float4(dka[4 * i], dka[4 * i + 1], dka[4 * i + 2], dka[4 * i + 3]));
    store4(dv + own + c,
           make_float4(dva[4 * i], dva[4 * i + 1], dva[4 * i + 2], dva[4 * i + 3]));
  }
}

template <typename T, int D, bool kDrop, bool kCausal>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const int32_t* mask,
                       const void* stats, Dropout drop, void* dq, void* dk,
                       void* dv, void* delta, int B, int L, int H, float scale,
                       cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const float2* st = static_cast<const float2*>(stats);
  float* dl = static_cast<float*>(delta);
  const dim3 grid(L / kRows, H, B);
  attention_bwd_dq<T, D, kDrop, kCausal><<<grid, kThreads, 0, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), gt, mask, st, drop,
      static_cast<T*>(dq), dl, L, H, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv<T, D, kDrop, kCausal><<<grid, kThreads, 0, stream>>>(
      qt, kt, vt, gt, mask, st, dl, drop, static_cast<T*>(dk),
      static_cast<T*>(dv), L, H, scale);
  return cudaGetLastError();
}

}  // namespace
