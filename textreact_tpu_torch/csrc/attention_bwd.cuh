// The attention backward kernels (dQ pass, dK/dV pass), shared by
// fused_attention_bwd.cu (non-causal, with and without dropout) and
// causal_attention_bwd.cu (causal, no dropout). What they compute and their
// design are set out at the head of fused_attention_bwd.cu.
//
// Two pairs of kernels, chosen by the element type alone:
// - `attention_bwd_dq_exact`, `attention_bwd_dkv_exact` (float32): f32 FMA
//   arithmetic throughout, the path that shows the algorithm exact to
//   summation order;
// - `attention_bwd_dq_tc`, `attention_bwd_dkv_tc` (bfloat16): all five
//   products on the tensor cores.
//
// Both are compiled for a width W (32, 64, 128) and take the head dim D (a
// multiple of 8, at most W) at run time, as the forward kernels do
// (attention_fwd.cuh): only D columns of a head are read or written.
//
// kCausal: query row i sees keys 0 .. i only, so p = 0 above the diagonal.
// The dQ pass of a block of rows streams the key tiles below its last row;
// the dK/dV pass of a block of keys streams the query tiles from its first
// key on. Inside the tiles that cross the diagonal the test compares the
// GLOBAL row and column, not the tile's.

#pragma once

#include <type_traits>

#include "attention_mma.cuh"

namespace {

constexpr int kThreads = 128;          // threads per block
constexpr int kRows = kThreads / 2;    // rows per block, two threads a row
constexpr int kTile = 32;              // rows of the streamed tile

// Stage `kTile` rows of this head (D elements each, row stride HD) in
// shared memory as f32, in rows of W.
template <typename T, int W>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, int64_t HD,
                                           float (*dst)[W], int D, int t) {
  constexpr int C = W / 4;  // groups of four per row
  for (int idx = t; idx < kTile * C; idx += kThreads) {
    const int j = idx / C;
    const int c = idx % C;
    if (4 * c < D) {
      *reinterpret_cast<float4*>(&dst[j][4 * c]) = load4(src + (int64_t)j * HD + 4 * c);
    }
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

// dQ pass, exact path; also writes delta = rowsum(dO * O) for the dK/dV pass.
// A thread's groups of four lie below D for the first D / 8 of its N (D is a
// multiple of 8); every loop over them stops there.
template <typename T, int W, bool kDrop, bool kCausal>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_exact(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const int32_t* __restrict__ mask,
                 const float2* __restrict__ stats, Dropout drop,
                 T* __restrict__ dq, float* __restrict__ delta, int L, int H,
                 int D, float scale) {
  constexpr int N = W / 8;  // groups of four this thread holds
  __shared__ __align__(16) float ks[kTile][W];
  __shared__ __align__(16) float vs[kTile][W];
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
  const uint32_t dbh = tr::dropout_head(drop, b, h);  // its dropout coordinate
  const uint64_t seed = kDrop ? (uint64_t)*drop.seed : 0;
  const float inv_keep = kDrop ? drop.inv_keep : 1.f;

  float qr[4 * N], gr[4 * N], acc[4 * N];
  float dl = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[4 * i] = acc[4 * i + 1] = acc[4 * i + 2] = acc[4 * i + 3] = 0.f;
    if (8 * i >= D) {
      qr[4 * i] = qr[4 * i + 1] = qr[4 * i + 2] = qr[4 * i + 3] = 0.f;
      gr[4 * i] = gr[4 * i + 1] = gr[4 * i + 2] = gr[4 * i + 3] = 0.f;
      continue;
    }
    const int c = 4 * (2 * i + half);
    const float4 qv = load4(q + own + c);
    const float4 gv = load4(dout + own + c);
    const float4 ov = load4(o + own + c);
    qr[4 * i] = qv.x, qr[4 * i + 1] = qv.y, qr[4 * i + 2] = qv.z, qr[4 * i + 3] = qv.w;
    gr[4 * i] = gv.x, gr[4 * i + 1] = gv.y, gr[4 * i + 2] = gv.z, gr[4 * i + 3] = gv.w;
    dl = dot4(ov, gr + 4 * i, dl);
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
    stage_tile<T, W>(k + head + (int64_t)k0 * HD, HD, ks, D, t);
    stage_tile<T, W>(v + head + (int64_t)k0 * HD, HD, vs, D, t);
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
        tr::attention_bits(seed, dbh, (uint32_t)row,
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
          if (8 * i >= D) break;
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
          if (8 * i >= D) break;
          const int c = 4 * (2 * i + half);
          axpy4(ds, *reinterpret_cast<const float4*>(&ks[j][c]), acc + 4 * i);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (8 * i >= D) break;
    const int c = 4 * (2 * i + half);
    store4(dq + own + c,
           make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]));
  }
}

// dK/dV pass, exact path; reads the delta that the dQ pass wrote. Its loops
// over the head stop at D as the dQ pass's do.
template <typename T, int W, bool kDrop, bool kCausal>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_exact(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const int32_t* __restrict__ mask,
                  const float2* __restrict__ stats,
                  const float* __restrict__ delta, Dropout drop,
                  T* __restrict__ dk, T* __restrict__ dv, int L, int H, int D,
                  float scale) {
  constexpr int N = W / 8;  // groups of four this thread holds
  __shared__ __align__(16) float qs[kTile][W];
  __shared__ __align__(16) float dos[kTile][W];
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
  const uint32_t dbh = tr::dropout_head(drop, b, h);  // its dropout coordinate
  const uint64_t seed = kDrop ? (uint64_t)*drop.seed : 0;
  const float inv_keep = kDrop ? drop.inv_keep : 1.f;
  const float kb = (mask == nullptr || mask[(int64_t)b * L + col] > 0) ? 0.f : kMaskBias;
  const int word = col & 3;  // this key's word of a Philox draw

  float kr[4 * N], vr[4 * N], dka[4 * N], dva[4 * N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    dka[4 * i] = dka[4 * i + 1] = dka[4 * i + 2] = dka[4 * i + 3] = 0.f;
    dva[4 * i] = dva[4 * i + 1] = dva[4 * i + 2] = dva[4 * i + 3] = 0.f;
    if (8 * i >= D) {
      kr[4 * i] = kr[4 * i + 1] = kr[4 * i + 2] = kr[4 * i + 3] = 0.f;
      vr[4 * i] = vr[4 * i + 1] = vr[4 * i + 2] = vr[4 * i + 3] = 0.f;
      continue;
    }
    const int c = 4 * (2 * i + half);
    const float4 kv = load4(k + own + c);
    const float4 vv = load4(v + own + c);
    kr[4 * i] = kv.x, kr[4 * i + 1] = kv.y, kr[4 * i + 2] = kv.z, kr[4 * i + 3] = kv.w;
    vr[4 * i] = vv.x, vr[4 * i + 1] = vv.y, vr[4 * i + 2] = vv.z, vr[4 * i + 3] = vv.w;
  }

  // the first query row that sees this block's keys (a multiple of kTile)
  const int q_begin = kCausal ? (int)blockIdx.x * kRows : 0;
#pragma unroll 1
  for (int q0 = q_begin; q0 < L; q0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    stage_tile<T, W>(q + head + (int64_t)q0 * HD, HD, qs, D, t);
    stage_tile<T, W>(dout + head + (int64_t)q0 * HD, HD, dos, D, t);
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
          tr::attention_bits(seed, dbh, (uint32_t)(q0 + i4 + 2 * half + r),
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
          if (8 * n >= D) break;
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
          if (8 * n >= D) break;
          const int c = 4 * (2 * n + half);
          axpy4(ds, *reinterpret_cast<const float4*>(&qs[i][c]), dka + 4 * n);
          axpy4(pd, *reinterpret_cast<const float4*>(&dos[i][c]), dva + 4 * n);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (8 * i >= D) break;
    const int c = 4 * (2 * i + half);
    store4(dk + own + c,
           make_float4(dka[4 * i], dka[4 * i + 1], dka[4 * i + 2], dka[4 * i + 3]));
    store4(dv + own + c,
           make_float4(dva[4 * i], dva[4 * i + 1], dva[4 * i + 2], dva[4 * i + 3]));
  }
}

// Keys (dQ pass) or queries (dK/dV pass) a warp takes through its products
// at a time: the streamed tile of 64 goes in pieces, which cuts the
// accumulators of s and dP that are live beside those of the gradients. The
// dK/dV pass holds two gradient accumulators and two operand fragments, so
// it takes pieces of 16 and asks for three blocks an SM (168 registers;
// timed against pieces of 32 at 230 registers and two blocks: 8% faster).
// At W = 128 those accumulators alone are 128 registers a thread and its
// shared memory (89.6 KB) holds two blocks an SM at most: it asks for one,
// which leaves ptxas all 255 registers.
constexpr int kChunkDq = 32;
constexpr int kChunkDkv = 16;
constexpr int kDkvBlocksPerSm = 3;

constexpr int dkv_blocks_per_sm(int W) { return W <= 64 ? kDkvBlocksPerSm : 1; }
// The dQ pass asks for the blocks its registers allowed before it took the
// head dim at run time: at W = 64 the causal pass grew from three blocks an
// SM (168 registers) to 176-178 registers and two, and ran slower on an
// H100; the bound holds it at three. At W = 32 four (it needs fewer than
// the 128 registers that leaves), at W = 128 one (255 registers).
constexpr int dq_blocks_per_sm(int W) { return W == 32 ? 4 : W == 64 ? 3 : 1; }

template <int W>
constexpr int dq_tc_shared_bytes() {
  return 4 * tile_bytes<W>() + 2 * kTcTile * (int)sizeof(int32_t);
}

template <int W, bool kDrop, bool kBits = false>
constexpr int dkv_tc_shared_bytes() {
  return 5 * tile_bytes<W>() + 2 * kTcTile * (int)(sizeof(float2) + sizeof(float)) +
         (kDrop ? 2 * kTcTile * 2 * (int)sizeof(uint32_t) : 0) +
         (kBits ? 2 * kTcTile * 2 * (int)sizeof(uint32_t) : 0);
}

// dQ pass, tensor-core path; also writes delta = rowsum(dO * O). A block of
// four warps owns 64 query rows (16 a warp, q and dO as A fragments in
// registers) and streams the key tiles as the forward does. Per piece of
// kChunkDq keys: S = q k^T and dP = dO v^T, P = exp(S - m) / l, dS = P (keep
// inv_keep dP - delta) scale rounded to bf16 in registers, dQ += dS k.
// kBits: `mask` holds the packed (B, L, L) admission bits and
// `keep_words` the packed keep bits, which this pass reads instead of
// drawing and writing them (attention_fwd_tc's kBits).
template <int W, bool kDrop, bool kCausal, bool kBits = false>
__global__ void __launch_bounds__(kTcThreads, dq_blocks_per_sm(W))
attention_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout,
                    const int32_t* __restrict__ mask,
                    const float2* __restrict__ stats, Dropout drop,
                    bf16* __restrict__ dq, float* __restrict__ delta,
                    uint32_t* __restrict__ keep_words, int L, int H, int D,
                    float scale) {
  constexpr int LD = W + kPad;
  constexpr int kChunk = kChunkDq;
  static_assert(kChunkDq == 32, "a piece of keys fills one word of keep bits");
  constexpr int NT = kChunk / 8;
  // two stages of k and v, then of the key mask (dq_tc_shared_bytes)
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16 (*ks)[kTcTile * LD] = reinterpret_cast<bf16 (*)[kTcTile * LD]>(tc_smem);
  bf16 (*vs)[kTcTile * LD] = ks + 2;
  int32_t (*ms)[kTcTile] = reinterpret_cast<int32_t (*)[kTcTile]>(vs + 2);

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
    // with kCausal the last blocks of rows stream the most tiles: they start
  // first (timed against blockIdx order: 1% faster at L=512 and L=1024)
  const int qb = kCausal ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
  const int q0 = qb * kTcRows;
  const int row0 = q0 + 16 * warp;
  const int64_t HD = (int64_t)H * D;
  const int64_t head = (int64_t)b * L * HD + (int64_t)h * D;
  const uint32_t bh = (uint32_t)(b * H + h);
  const uint32_t dbh = tr::dropout_head(drop, b, h);  // its dropout coordinate
  const uint64_t seed = (kDrop && !kBits) ? (uint64_t)*drop.seed : 0;
  const float inv_keep = kDrop ? drop.inv_keep : 1.f;
  const int32_t* mrow = (kBits || mask == nullptr) ? nullptr : mask + (int64_t)b * L;
  const int n_tiles = kCausal ? qb + 1 : L / kTcTile;
  const KeyTiles kt = scan_key_tiles<kCausal>(mrow, L / kTcTile, lane);
  // kBits: this lane's row g in key tile 0 (row g + 8 is 8 further, tile i
  // i * L further)
  const uint2* abits = kBits ? reinterpret_cast<const uint2*>(mask) +
                                   (int64_t)b * (L / kTcTile) * L + row0 + g
                             : nullptr;
  const uint2* kbits = (kBits && kDrop) ? reinterpret_cast<const uint2*>(keep_words) +
                                              (int64_t)bh * (L / kTcTile) * L + row0 + g
                                        : nullptr;

  auto fetch = [&](int tile, int stage) {
    const int64_t off = head + (int64_t)tile * kTcTile * HD;
    copy_tile_async<W>(ks[stage], k + off, HD, D, t);
    copy_tile_async<W>(vs[stage], v + off, HD, D, t);
    if (mrow != nullptr && t < kTcTile / 4) {
      cp_async16(&ms[stage][4 * t], mrow + tile * kTcTile + 4 * t);
    }
  };

  // q and dO go through stage 1 into A fragments, once
  copy_tile_async<W>(ks[1], q + head + (int64_t)q0 * HD, HD, D, t);
  copy_tile_async<W>(vs[1], dout + head + (int64_t)q0 * HD, HD, D, t);
  cp_async_commit();
  int tile = next_tile(kt, 0, n_tiles);
  fetch(tile, 0);
  cp_async_commit();

  // delta of the warp's 16 rows, two lanes a row, while the copies fly: a
  // lane sums its half of the W columns, those below D, so the sum is the
  // one over inputs zero-padded to W, term for term
  float dl;
  {
    const int col0 = (lane & 1) * (W / 2);
    const int64_t own = head + (int64_t)(row0 + (lane >> 1)) * HD + col0;
    dl = 0.f;
#pragma unroll
    for (int c = 0; c < W / 16; ++c) {
      if (col0 + 8 * c >= D) break;
      const uint4 ov = *reinterpret_cast<const uint4*>(o + own + 8 * c);
      const uint4 gv = *reinterpret_cast<const uint4*>(dout + own + 8 * c);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(o2[i]), c2 = __bfloat1622float2(g2[i]);
        dl = fmaf(a.x, c2.x, dl);
        dl = fmaf(a.y, c2.y, dl);
      }
    }
    dl += __shfl_xor_sync(kFullWarp, dl, 1);
    if ((lane & 1) == 0) delta[(int64_t)bh * L + row0 + (lane >> 1)] = dl;
  }
  const float dl0 = __shfl_sync(kFullWarp, dl, 2 * g);       // row g
  const float dl1 = __shfl_sync(kFullWarp, dl, 2 * g + 16);  // row g + 8
  const float2 st0 = stats[(int64_t)bh * L + row0 + g];
  const float2 st1 = stats[(int64_t)bh * L + row0 + g + 8];
  const float m0 = st0.x, m1 = st1.x;
  const float linv0 = 1.f / st0.y, linv1 = 1.f / st1.y;

  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[W / 16][4], gf[W / 16][4];
  load_a<W>(qf, ks[1], 16 * warp, lane);
  load_a<W>(gf, vs[1], 16 * warp, lane);
  __syncthreads();  // stage 1 is free again

  float acc[W / 8][4];
#pragma unroll
  for (int j = 0; j < W / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int stage = 0;
#pragma unroll 1
  while (tile < n_tiles) {
    const int next = next_tile(kt, tile + 1, n_tiles);
    if (next < n_tiles) fetch(next, stage ^ 1);
    cp_async_commit();
    uint2 a0, a1, k0w, k1w;  // kBits: rows g, g + 8 of this key tile
    if constexpr (kBits) {
      a0 = abits[(int64_t)tile * L];
      a1 = abits[(int64_t)tile * L + 8];
      if constexpr (kDrop) {
        k0w = kbits[(int64_t)tile * L];
        k1w = kbits[(int64_t)tile * L + 8];
      }
    }
    cp_async_wait<1>();
    __syncthreads();

    const int k0 = tile * kTcTile;
#pragma unroll 1
    for (int c0 = 0; c0 < kTcTile; c0 += kChunk) {
      // kBits: the piece's word of rows g, g + 8 (a piece is 32 keys)
      uint32_t aw0 = 0u, aw1 = 0u, kw0 = 0u, kw1 = 0u;
      if constexpr (kBits) {
        aw0 = c0 ? a0.y : a0.x;
        aw1 = c0 ? a1.y : a1.x;
        if constexpr (kDrop) {
          kw0 = c0 ? k0w.y : k0w.x;
          kw1 = c0 ? k1w.y : k1w.x;
        }
      }
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
      mma_nt<NT, W>(s, qf, ks[stage], c0, lane);
      mma_nt<NT, W>(dp, gf, vs[stage], c0, lane);

      uint32_t dsf[NT / 2][4];  // dS as A fragments of dS k
      uint32_t w0 = 0u, w1 = 0u;  // keep bits of rows g, g + 8: bit = key % 32
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = c0 + 8 * j + 2 * tq;
        float b0 = 0.f, b1 = 0.f;
        if (mrow != nullptr) {
          const int2 mm = *reinterpret_cast<const int2*>(&ms[stage][c]);
          b0 = mm.x > 0 ? 0.f : kMaskBias;
          b1 = mm.y > 0 ? 0.f : kMaskBias;
        }
        float b2 = b0, b3 = b1;  // row g + 8
        const int sh = 8 * j + 2 * tq;  // this lane's keys' bit in a piece's word
        if constexpr (kBits) {
          b0 = ((aw0 >> sh) & 1u) ? 0.f : kMaskBias;
          b1 = ((aw0 >> sh) & 2u) ? 0.f : kMaskBias;
          b2 = ((aw1 >> sh) & 1u) ? 0.f : kMaskBias;
          b3 = ((aw1 >> sh) & 2u) ? 0.f : kMaskBias;
        }
        float p0 = __expf(fmaf(s[j][0], scale, b0) - m0) * linv0;
        float p1 = __expf(fmaf(s[j][1], scale, b1) - m0) * linv0;
        float p2 = __expf(fmaf(s[j][2], scale, b2) - m1) * linv1;
        float p3 = __expf(fmaf(s[j][3], scale, b3) - m1) * linv1;
        if (kCausal && tile == qb) {  // the tile on the diagonal
          const int col = k0 + c, row = row0 + g;
          if (col > row) p0 = 0.f;
          if (col + 1 > row) p1 = 0.f;
          if (col > row + 8) p2 = 0.f;
          if (col + 1 > row + 8) p3 = 0.f;
        }
        float g0 = dp[j][0], g1 = dp[j][1], g2 = dp[j][2], g3 = dp[j][3];
        if (kDrop) {
          uint32_t keep;
          if constexpr (kBits) {
            keep = ((kw0 >> sh) & 3u) | (((kw1 >> sh) & 3u) << 2);
          } else {
            keep = keep_bits(seed, drop.threshold, dbh, row0, k0 + c0 + 8 * j, g, tq);
          }
          g0 = (keep & 1u) ? g0 * inv_keep : 0.f;
          g1 = (keep & 2u) ? g1 * inv_keep : 0.f;
          g2 = (keep & 4u) ? g2 * inv_keep : 0.f;
          g3 = (keep & 8u) ? g3 * inv_keep : 0.f;
          w0 |= (keep & 3u) << sh;
          w1 |= (keep >> 2) << sh;
        }
        dsf[j >> 1][2 * (j & 1)] =
            pack_bf16(p0 * (g0 - dl0) * scale, p1 * (g1 - dl0) * scale);
        dsf[j >> 1][2 * (j & 1) + 1] =
            pack_bf16(p2 * (g2 - dl1) * scale, p3 * (g3 - dl1) * scale);
      }
      if (kDrop && !kBits) {
        // the dK/dV pass reads these bits instead of drawing them again: a
        // quad joins its rows' 32 bits, lane 0 stores row g, lane 1 row g + 8
        w0 |= __shfl_xor_sync(kFullWarp, w0, 1);
        w0 |= __shfl_xor_sync(kFullWarp, w0, 2);
        w1 |= __shfl_xor_sync(kFullWarp, w1, 1);
        w1 |= __shfl_xor_sync(kFullWarp, w1, 2);
        if (tq < 2) {
          const int64_t row =
              (int64_t)(bh * (L / kTcTile) + tile) * L + row0 + g + 8 * tq;
          keep_words[2 * row + c0 / 32] = tq == 0 ? w0 : w1;
        }
      }
      mma_tn<NT / 2, W>(acc, dsf, ks[stage], c0, lane);
    }

    __syncthreads();  // every warp is done with this stage
    tile = next;
    stage ^= 1;
  }

  store_acc<W>(dq + head + (int64_t)row0 * HD, HD, acc, 1.f, 1.f, D, g, tq);
}

// dK/dV pass, tensor-core path; reads the delta that the dQ pass wrote. A
// block of four warps owns 64 keys (16 a warp, k and v as A fragments in
// registers) and streams the queries in tiles of 64 with their dO, m, l and
// delta. It computes the TRANSPOSED tiles S^T = k q^T and dP^T = v dO^T, so
// that E^T and dS^T come out as the A fragments of dV += (E keep)^T (dO
// inv_keep / l) and dK += dS^T q without a trip through shared memory. dV
// rounds where the TPU kernel does (ops/fused_attention.py:140-141): the
// unnormalised dropped weights E keep, and dO scaled per query row by
// inv_keep / l, which the block writes once a tile into its own buffer. It
// draws no dropout bits: in the transposed tile the four keys of one Philox
// draw lie in four lanes, and the dQ pass has drawn every bit already, so that pass leaves
// them in `keep_words` (two 32-bit words for each (key tile, query): bit =
// key % 32) and this one copies a query tile's 512 bytes in with the tile. A
// block whose keys are all masked writes zeros where that is exact
// (scan_key_tiles); the dQ pass leaves out the same tiles, so no word is read
// that was not written. kBits: `mask` holds the packed (B, L, L) admission
// bits, which a query tile's words of this block's keys bring in beside its
// keep bits, in the same layout; no block is left out.
template <int W, bool kDrop, bool kCausal, bool kBits = false>
__global__ void __launch_bounds__(kTcThreads, dkv_blocks_per_sm(W))
attention_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const int32_t* __restrict__ mask,
                     const float2* __restrict__ stats,
                     const float* __restrict__ delta,
                     const uint32_t* __restrict__ keep_words, Dropout drop,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int H,
                     int D, float scale) {
  constexpr int LD = W + kPad;
  constexpr int kChunk = kChunkDkv;
  constexpr int NT = kChunk / 8;
  // dkv_tc_shared_bytes: two stages of q and of dO, dO inv_keep / l rounded
  // (dsc), two stages of the rows' (max, normaliser) and delta, with
  // dropout two of the keep bits of (query, this block's 64 keys) as the dQ
  // pass wrote them, and with kBits two of their admission bits
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16 (*qs)[kTcTile * LD] = reinterpret_cast<bf16 (*)[kTcTile * LD]>(tc_smem);
  bf16 (*dos)[kTcTile * LD] = qs + 2;
  bf16* dsc = dos[2];
  float2 (*sts)[kTcTile] = reinterpret_cast<float2 (*)[kTcTile]>(dsc + kTcTile * LD);
  float (*dls)[kTcTile] = reinterpret_cast<float (*)[kTcTile]>(sts + 2);
  uint32_t (*kws)[kTcTile][2] = reinterpret_cast<uint32_t (*)[kTcTile][2]>(dls + 2);
  uint32_t (*mws)[kTcTile][2] = kws + (kDrop ? 2 : 0);

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kb = blockIdx.x;  // with kCausal the first blocks stream most
  const int key0 = kb * kTcRows + 16 * warp;  // this warp's first key
  const int64_t HD = (int64_t)H * D;
  const int64_t head = (int64_t)b * L * HD + (int64_t)h * D;
  const uint32_t bh = (uint32_t)(b * H + h);
  const float inv_keep = kDrop ? drop.inv_keep : 1.f;
  const int32_t* mrow = (kBits || mask == nullptr) ? nullptr : mask + (int64_t)b * L;
  // where this warp's keys g, g + 8 stand in a query's two words of bits
  const int kw_half = warp >> 1, kw_shift = 16 * (warp & 1) + g;

  const KeyTiles kt = scan_key_tiles<kCausal>(mrow, L / kTcTile, lane);
  if (kt.skip && !((kt.valid >> kb) & 1ull)) {
    // no query gives these keys any weight
    constexpr int C = W / 8;
    const int64_t base = head + (int64_t)kb * kTcRows * HD;
    for (int i = t; i < kTcRows * C; i += kTcThreads) {
      if (8 * (i % C) >= D) continue;
      const int64_t off = base + (int64_t)(i / C) * HD + 8 * (i % C);
      *reinterpret_cast<uint4*>(dk + off) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dv + off) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  auto fetch = [&](int tile, int stage) {
    const int64_t off = head + (int64_t)tile * kTcTile * HD;
    const int64_t row = (int64_t)bh * L + tile * kTcTile;
    copy_tile_async<W>(qs[stage], q + off, HD, D, t);
    copy_tile_async<W>(dos[stage], dout + off, HD, D, t);
    if (t < kTcTile / 2) {
      cp_async16(&sts[stage][2 * t], stats + row + 2 * t);
    } else if (t < kTcTile / 2 + kTcTile / 4) {
      const int i = t - kTcTile / 2;
      cp_async16(&dls[stage][4 * i], delta + row + 4 * i);
    }
    if constexpr (kDrop) {
      const int i = t - kTcTile;  // the block's upper half copies the bits
      if (i >= 0 && i < kTcTile / 2) {
        const int64_t qry =
            (int64_t)(bh * (L / kTcTile) + kb) * L + tile * kTcTile + 2 * i;
        cp_async16(&kws[stage][2 * i][0], keep_words + 2 * qry);
      }
    }
    if constexpr (kBits) {
      const int i = t - (kTcTile + kTcTile / 2);  // the last quarter copies them
      if (i >= 0) {
        const int64_t qry =
            ((int64_t)b * (L / kTcTile) + kb) * L + tile * kTcTile + 2 * i;
        cp_async16(&mws[stage][2 * i][0],
                   reinterpret_cast<const uint32_t*>(mask) + 2 * qry);
      }
    }
  };

  // k and v go through stage 1 into A fragments, once
  copy_tile_async<W>(qs[1], k + head + (int64_t)kb * kTcRows * HD, HD, D, t);
  copy_tile_async<W>(dos[1], v + head + (int64_t)kb * kTcRows * HD, HD, D, t);
  cp_async_commit();
  const int n_tiles = L / kTcTile;
  int tile = kCausal ? kb : 0;  // the first query tile that sees these keys
  fetch(tile, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t kf[W / 16][4], vf[W / 16][4];
  load_a<W>(kf, qs[1], 16 * warp, lane);
  load_a<W>(vf, dos[1], 16 * warp, lane);
  __syncthreads();  // stage 1 is free again

  float kb0 = 0.f, kb1 = 0.f;  // the bias of keys g, g + 8
  if (mrow != nullptr) {
    kb0 = mrow[key0 + g] > 0 ? 0.f : kMaskBias;
    kb1 = mrow[key0 + g + 8] > 0 ? 0.f : kMaskBias;
  }

  float dka[W / 8][4], dva[W / 8][4];
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
  }

  int stage = 0;
#pragma unroll 1
  for (; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) fetch(tile + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // the B operand of dV: every warp has left the last tile's (above);
    // its columns past D are dO's zeros, scaled
    for (int i = t; i < kTcTile * (W / 8); i += kTcThreads) {
      const int r = i / (W / 8), c = 8 * (i % (W / 8));
      const float f = inv_keep / sts[stage][r].y;
      const uint4 raw = *reinterpret_cast<const uint4*>(&dos[stage][r * LD + c]);
      const bf16* x = reinterpret_cast<const bf16*>(&raw);
      uint4 scaled;
      uint32_t* w = reinterpret_cast<uint32_t*>(&scaled);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = pack_bf16(__bfloat162float(x[2 * j]) * f, __bfloat162float(x[2 * j + 1]) * f);
      }
      *reinterpret_cast<uint4*>(&dsc[r * LD + c]) = scaled;
    }
    __syncthreads();

    const int r0 = tile * kTcTile;  // the tile's first query
#pragma unroll 1
    for (int c0 = 0; c0 < kTcTile; c0 += kChunk) {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
      mma_nt<NT, W>(s, kf, qs[stage], c0, lane);
      mma_nt<NT, W>(dp, vf, dos[stage], c0, lane);

      uint32_t pf[NT / 2][4], dsf[NT / 2][4];  // (E keep)^T, dS^T
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = c0 + 8 * j + 2 * tq;  // this lane's queries c, c + 1
        const float4 st = *reinterpret_cast<const float4*>(&sts[stage][c]);
        const float2 dl = *reinterpret_cast<const float2*>(&dls[stage][c]);
        const float li0 = 1.f / st.y, li1 = 1.f / st.w;
        // the bias of (key g, query c), (g, c + 1), (g + 8, c), (g + 8, c + 1)
        float ba = kb0, bb = kb0, bc = kb1, bd = kb1;
        if constexpr (kBits) {
          const uint4 mw = *reinterpret_cast<const uint4*>(&mws[stage][c][0]);
          const uint32_t ma = (kw_half ? mw.y : mw.x) >> kw_shift;  // query c
          const uint32_t mb = (kw_half ? mw.w : mw.z) >> kw_shift;  // c + 1
          ba = (ma & 1u) ? 0.f : kMaskBias;
          bb = (mb & 1u) ? 0.f : kMaskBias;
          bc = (ma & 256u) ? 0.f : kMaskBias;
          bd = (mb & 256u) ? 0.f : kMaskBias;
        }
        float e0 = __expf(fmaf(s[j][0], scale, ba) - st.x);
        float e1 = __expf(fmaf(s[j][1], scale, bb) - st.z);
        float e2 = __expf(fmaf(s[j][2], scale, bc) - st.x);
        float e3 = __expf(fmaf(s[j][3], scale, bd) - st.z);
        if (kCausal && tile == kb) {  // the tile on the diagonal
          const int qry = r0 + c, key = key0 + g;
          if (qry < key) e0 = 0.f;
          if (qry + 1 < key) e1 = 0.f;
          if (qry < key + 8) e2 = 0.f;
          if (qry + 1 < key + 8) e3 = 0.f;
        }
        const float p0 = e0 * li0, p1 = e1 * li1, p2 = e2 * li0, p3 = e3 * li1;
        float g0 = dp[j][0], g1 = dp[j][1], g2 = dp[j][2], g3 = dp[j][3];
        float d0 = e0, d1 = e1, d2 = e2, d3 = e3;  // the weights that met v
        if constexpr (kDrop) {
          const uint4 kw = *reinterpret_cast<const uint4*>(&kws[stage][c][0]);
          const uint32_t wa = (kw_half ? kw.y : kw.x) >> kw_shift;  // query c
          const uint32_t wb = (kw_half ? kw.w : kw.z) >> kw_shift;  // c + 1
          g0 = (wa & 1u) ? g0 * inv_keep : 0.f;
          g1 = (wb & 1u) ? g1 * inv_keep : 0.f;
          g2 = (wa & 256u) ? g2 * inv_keep : 0.f;
          g3 = (wb & 256u) ? g3 * inv_keep : 0.f;
          d0 = (wa & 1u) ? d0 : 0.f;
          d1 = (wb & 1u) ? d1 : 0.f;
          d2 = (wa & 256u) ? d2 : 0.f;
          d3 = (wb & 256u) ? d3 : 0.f;
        }
        pf[j >> 1][2 * (j & 1)] = pack_bf16(d0, d1);
        pf[j >> 1][2 * (j & 1) + 1] = pack_bf16(d2, d3);
        dsf[j >> 1][2 * (j & 1)] =
            pack_bf16(p0 * (g0 - dl.x) * scale, p1 * (g1 - dl.y) * scale);
        dsf[j >> 1][2 * (j & 1) + 1] =
            pack_bf16(p2 * (g2 - dl.x) * scale, p3 * (g3 - dl.y) * scale);
      }
      mma_tn<NT / 2, W>(dva, pf, dsc, c0, lane);
      mma_tn<NT / 2, W>(dka, dsf, qs[stage], c0, lane);
    }

    __syncthreads();  // every warp is done with this stage
    stage ^= 1;
  }

  store_acc<W>(dk + head + (int64_t)key0 * HD, HD, dka, 1.f, 1.f, D, g, tq);
  store_acc<W>(dv + head + (int64_t)key0 * HD, HD, dva, 1.f, 1.f, D, g, tq);
}

// float32 takes the exact kernels, bfloat16 the tensor-core kernels, both
// at width W for head dim D. The dQ pass writes the delta, and with dropout
// the keep bits (`keep_words`, L^2 / 8 bytes a head; unused by the exact
// kernels), that the dK/dV pass reads: the stream orders them.
template <typename T, int W, bool kDrop, bool kCausal>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const int32_t* mask,
                       const void* stats, Dropout drop, void* dq, void* dk,
                       void* dv, void* delta, void* keep_words, int B, int L,
                       int H, int D, float scale, cudaStream_t stream) {
  if (kernel_width(D) != W) return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const float2* st = static_cast<const float2*>(stats);
  float* dl = static_cast<float*>(delta);
  if constexpr (std::is_same<T, float>::value) {
    if (L % kRows != 0) return cudaErrorInvalidValue;
    const dim3 grid(L / kRows, H, B);
    attention_bwd_dq_exact<T, W, kDrop, kCausal><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, static_cast<const T*>(o), gt, mask, st, drop,
        static_cast<T*>(dq), dl, L, H, D, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attention_bwd_dkv_exact<T, W, kDrop, kCausal><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, gt, mask, st, dl, drop, static_cast<T*>(dk),
        static_cast<T*>(dv), L, H, D, scale);
  } else {
    if (L % kTcTile != 0 || (kDrop && keep_words == nullptr)) {
      return cudaErrorInvalidValue;
    }
    uint32_t* kw = static_cast<uint32_t*>(keep_words);
    const dim3 grid(L / kTcRows, H, B);
    constexpr int dq_bytes = dq_tc_shared_bytes<W>();
    constexpr int dkv_bytes = dkv_tc_shared_bytes<W, kDrop>();
    auto dq_kernel = &attention_bwd_dq_tc<W, kDrop, kCausal>;
    auto dkv_kernel = &attention_bwd_dkv_tc<W, kDrop, kCausal>;
    cudaError_t err = allow_shared(dq_kernel, dq_bytes);
    if (err != cudaSuccess) return err;
    err = allow_shared(dkv_kernel, dkv_bytes);
    if (err != cudaSuccess) return err;
    dq_kernel<<<grid, kTcThreads, dq_bytes, stream>>>(
        qt, kt, vt, static_cast<const T*>(o), gt, mask, st, drop,
        static_cast<T*>(dq), dl, kw, L, H, D, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dkv_kernel<<<grid, kTcThreads, dkv_bytes, stream>>>(
        qt, kt, vt, gt, mask, st, dl, kw, drop, static_cast<T*>(dk),
        static_cast<T*>(dv), L, H, D, scale);
  }
  return cudaGetLastError();
}

// The tensor-core passes under a packed (B, L, L) admission mask `admit`
// (B, L / 64, L, 2) words; with kDrop their keep bits are `keep` (B, H,
// L / 64, L, 2), which both passes read (mask3d_attention_bwd.cu).
template <int W, bool kDrop>
cudaError_t launch_bwd_bits(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const uint32_t* admit,
                            const void* stats, const uint32_t* keep, Dropout drop,
                            void* dq, void* dk, void* dv, void* delta, int B,
                            int L, int H, int D, float scale, cudaStream_t stream) {
  if (kernel_width(D) != W || L % kTcTile != 0 || admit == nullptr ||
      (kDrop && keep == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(dout);
  const int32_t* m = reinterpret_cast<const int32_t*>(admit);
  const float2* st = static_cast<const float2*>(stats);
  float* dl = static_cast<float*>(delta);
  uint32_t* kw = const_cast<uint32_t*>(keep);  // read, never written, here
  const dim3 grid(L / kTcRows, H, B);
  constexpr int dq_bytes = dq_tc_shared_bytes<W>();
  constexpr int dkv_bytes = dkv_tc_shared_bytes<W, kDrop, true>();
  auto dq_kernel = &attention_bwd_dq_tc<W, kDrop, false, true>;
  auto dkv_kernel = &attention_bwd_dkv_tc<W, kDrop, false, true>;
  cudaError_t err = allow_shared(dq_kernel, dq_bytes);
  if (err != cudaSuccess) return err;
  err = allow_shared(dkv_kernel, dkv_bytes);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, kTcThreads, dq_bytes, stream>>>(
      qt, kt, vt, static_cast<const bf16*>(o), gt, m, st, drop,
      static_cast<bf16*>(dq), dl, kw, L, H, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<grid, kTcThreads, dkv_bytes, stream>>>(
      qt, kt, vt, gt, m, st, dl, kw, drop, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), L, H, D, scale);
  return cudaGetLastError();
}

}  // namespace
