// The attention forward kernels, shared by fused_attention.cu (non-causal,
// with and without dropout) and causal_attention.cu (causal, no dropout).
// What they compute, their bound and their design are set out at the head
// of fused_attention.cu; the causal variant's at the head of
// causal_attention.cu. The two sources are separate libraries so that their
// variants compile side by side.
//
// Two kernels, chosen by the element type alone:
// - `attention_fwd_exact` (float32): f32 FMA arithmetic throughout, the path
//   that shows the algorithm exact to summation order;
// - `attention_fwd_tc` (bfloat16): both products on the tensor cores.
//
// Both are compiled for a width W (32, 64, 128) and take the head dim D
// (a multiple of 8, at most W) at run time: q, k, v and out are (B, L, H * D),
// and only D columns of a head are read or written (attention_common.cuh).

#pragma once

#include <type_traits>

#include "attention_mma.cuh"

namespace {

// The exact path. kCausal: query row i sees keys 0 .. i only. The block of query rows
// q0 .. q0 + kBQ - 1 then streams the key tiles below q0 + kBQ and no
// others; inside the tiles that cross the diagonal a key above the row gets
// the score -inf, so its weight is exactly 0 (every row sees key 0, so the
// running max is finite from the first tile on). The key mask stays the
// additive -1e9 of the non-causal kernel. Every loop over the head stops at
// D: the terms past it, zeros over zeros, would add exactly nothing.
template <typename T, int W, bool kDrop, bool kCausal>
__global__ void __launch_bounds__(kBQ)
attention_fwd_exact(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int32_t* __restrict__ mask,
              T* __restrict__ out, float2* __restrict__ stats, Dropout drop,
              int L, int H, int D, float scale) {
  __shared__ __align__(16) float ks[kBK][W];
  __shared__ __align__(16) float vs[kBK][W];
  __shared__ float kbias[kBK];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row_i = blockIdx.x * kBQ + threadIdx.x;
  const int64_t row = row_i;
  const int64_t HD = (int64_t)H * D;
  const int64_t head = (int64_t)b * L * HD + (int64_t)h * D;
  const uint32_t bh = (uint32_t)(b * H + h);
  const uint32_t dbh = tr::dropout_head(drop, b, h);  // its dropout coordinate
  const uint64_t seed = kDrop ? (uint64_t)*drop.seed : 0;
  // one past the last key this block of rows can see
  const int k_end = kCausal ? (int)(blockIdx.x + 1) * kBQ : L;

  float qr[W];
  float acc[W];
  const T* qp = q + head + row * HD;
#pragma unroll
  for (int d = 0; d < W; ++d) {
    qr[d] = d < D ? to_f32(qp[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;  // running row max
  float l = 0.f;        // running softmax normaliser (undropped weights)

#pragma unroll 1
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kBK * W; i += kBQ) {
      const int j = i / W;
      const int d = i % W;
      if (d >= D) continue;
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
    for (int d = 0; d < W; d += 4) {
      if (d >= D) break;
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
    for (int d = 0; d < W; ++d) acc[d] *= corr;
    uint32_t bits[4];
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float p = expf(s[j] - mt);
      l += p;
      if (kDrop) {
        if ((j & 3) == 0) {
          tr::attention_bits(seed, dbh, (uint32_t)row_i, (uint32_t)((k0 + j) >> 2), bits);
        }
        if (bits[j & 3] < drop.threshold) p = 0.f;
      }
#pragma unroll
      for (int d = 0; d < W; d += 4) {
        if (d >= D) break;
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
  for (int d = 0; d < W; ++d) {
    if (d < D) op[d] = from_f32<T>(acc[d] * r);
  }
  if (stats != nullptr) stats[((int64_t)bh) * L + row] = make_float2(m, l);
}

// The tensor-core path (bf16). A block of four warps owns 64 query rows of
// one (batch, head), 16 a warp, and streams the keys in tiles of 64 that stay
// bf16 in shared memory, copied asynchronously into two stages so the next
// tile's loads run under this tile's products. Per tile and warp: S = q k^T
// (16 x 64, f32 accumulators), the online softmax on those accumulators in
// registers (a row lives in the four lanes of a quad), the weights added to
// l, then masked by the dropout bits, rounded to bf16 and fed back as the A
// fragments of P v. Key tiles that hold no valid key are left out where that
// changes no bit (scan_key_tiles); with kCausal the tiles above the diagonal
// are never visited, the diagonal tile gets -inf above the diagonal, and the
// blocks with the most tiles start first. The tiles are W wide, their
// columns D .. W - 1 zero (copy_tile_async).
//
// kBits (mask3d_attention.cu): `mask` is not a (B, L) key mask but a
// (B, L, L) admission mask packed to bits (mask3d_attention.cu: two words a
// query row and key tile), which adds -1e9 to the score of each barred
// (query, key) as the (B, L) mask does to a barred key; with kDrop the keep
// bits come packed the same way a head from `keep_in` (B, H, L / 64, L, 2)
// instead of from the generator. No key tile is left out.
template <int W, bool kDrop, bool kCausal, bool kBits = false>
__global__ void __launch_bounds__(kTcThreads)
attention_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int32_t* __restrict__ mask,
                 bf16* __restrict__ out, float2* __restrict__ stats, Dropout drop,
                 int L, int H, int D, float scale,
                 const uint32_t* __restrict__ keep_in) {
  static_assert(!(kBits && kCausal), "a packed mask has no causal variant");
  constexpr int LD = W + kPad;
  constexpr int NT = kTcTile / 8;  // score tiles of 8 keys
  // two stages of k and v, then of the key mask (fwd_tc_shared_bytes)
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
  const int row0 = q0 + 16 * warp;  // this warp's first row; the lane's are
                                    // row0 + g and row0 + g + 8
  const int64_t HD = (int64_t)H * D;
  const int64_t head = (int64_t)b * L * HD + (int64_t)h * D;
  const uint32_t bh = (uint32_t)(b * H + h);
  const uint32_t dbh = tr::dropout_head(drop, b, h);  // its dropout coordinate
  const uint64_t seed = (kDrop && !kBits) ? (uint64_t)*drop.seed : 0;
  const int32_t* mrow = (kBits || mask == nullptr) ? nullptr : mask + (int64_t)b * L;
  // tiles this block of rows can see, and those among them worth a visit
  const int n_tiles = kCausal ? qb + 1 : L / kTcTile;
  const KeyTiles kt = scan_key_tiles<kCausal>(mrow, L / kTcTile, lane);
  // kBits: the words of this lane's row g in key tile 0; row g + 8 is 8
  // further, tile i is i * L further
  const uint2* abits = kBits ? reinterpret_cast<const uint2*>(mask) +
                                   (int64_t)b * (L / kTcTile) * L + row0 + g
                             : nullptr;
  const uint2* kbits = (kBits && kDrop) ? reinterpret_cast<const uint2*>(keep_in) +
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

  // q goes through stage 1 of the k buffer into A fragments, once
  copy_tile_async<W>(ks[1], q + head + (int64_t)q0 * HD, HD, D, t);
  cp_async_commit();
  int tile = next_tile(kt, 0, n_tiles);
  fetch(tile, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[W / 16][4];
  load_a<W>(qf, ks[1], 16 * warp, lane);
  __syncthreads();  // stage 1 is free again

  float o[W / 8][4];
#pragma unroll
  for (int j = 0; j < W / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;  // this lane's share of the rows' normalisers

  int stage = 0;
#pragma unroll 1
  while (tile < n_tiles) {
    const int next = next_tile(kt, tile + 1, n_tiles);
    if (next < n_tiles) fetch(next, stage ^ 1);
    cp_async_commit();
    // kBits: rows g, g + 8 of this key tile, admission and keep bits
    uint2 a0, a1, k0w, k1w;
    if constexpr (kBits) {
      a0 = abits[(int64_t)tile * L];
      a1 = abits[(int64_t)tile * L + 8];
      if constexpr (kDrop) {
        k0w = kbits[(int64_t)tile * L];
        k1w = kbits[(int64_t)tile * L + 8];
      }
    }
    cp_async_wait<1>();  // this tile has landed; the next may be in flight
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_nt<NT, W>(s, qf, ks[stage], 0, lane);

    const int k0 = tile * kTcTile;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * tq;
      float b0 = 0.f, b1 = 0.f;
      if (mrow != nullptr) {
        const int2 mm = *reinterpret_cast<const int2*>(&ms[stage][c]);
        b0 = mm.x > 0 ? 0.f : kMaskBias;
        b1 = mm.y > 0 ? 0.f : kMaskBias;
      }
      float b2 = b0, b3 = b1;  // row g + 8
      if constexpr (kBits) {
        const uint32_t w0 = (j < NT / 2 ? a0.x : a0.y) >> (c & 31);
        const uint32_t w1 = (j < NT / 2 ? a1.x : a1.y) >> (c & 31);
        b0 = (w0 & 1u) ? 0.f : kMaskBias;
        b1 = (w0 & 2u) ? 0.f : kMaskBias;
        b2 = (w1 & 1u) ? 0.f : kMaskBias;
        b3 = (w1 & 2u) ? 0.f : kMaskBias;
      }
      s[j][0] = fmaf(s[j][0], scale, b0);
      s[j][1] = fmaf(s[j][1], scale, b1);
      s[j][2] = fmaf(s[j][2], scale, b2);
      s[j][3] = fmaf(s[j][3], scale, b3);
      if (kCausal && tile == qb) {  // the tile on the diagonal
        const int col = k0 + c, row = row0 + g;
        if (col > row) s[j][0] = -INFINITY;
        if (col + 1 > row) s[j][1] = -INFINITY;
        if (col > row + 8) s[j][2] = -INFINITY;
        if (col + 1 > row + 8) s[j][3] = -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFullWarp, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFullWarp, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFullWarp, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFullWarp, mx1, 2));
    // 0 on the first tile (m = -inf); the max is finite from then on: every
    // score is finite but those above the diagonal, and a causal block's
    // first tile is tile 0, whose key 0 every row sees
    const float corr0 = __expf(m0 - mx0), corr1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= corr0;
    l1 *= corr1;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      o[j][0] *= corr0;
      o[j][1] *= corr0;
      o[j][2] *= corr1;
      o[j][3] *= corr1;
    }

    uint32_t pf[NT / 2][4];  // the weights as A fragments of p v
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float p0 = __expf(s[j][0] - m0), p1 = __expf(s[j][1] - m0);
      float p2 = __expf(s[j][2] - m1), p3 = __expf(s[j][3] - m1);
      l0 += p0 + p1;  // the normaliser runs over the undropped weights
      l1 += p2 + p3;
      if (kDrop) {
        uint32_t keep;
        if constexpr (kBits) {
          const int sh = (8 * j + 2 * tq) & 31;
          keep = (((j < NT / 2 ? k0w.x : k0w.y) >> sh) & 3u) |
                 ((((j < NT / 2 ? k1w.x : k1w.y) >> sh) & 3u) << 2);
        } else {
          keep = keep_bits(seed, drop.threshold, dbh, row0, k0 + 8 * j, g, tq);
        }
        if (!(keep & 1u)) p0 = 0.f;
        if (!(keep & 2u)) p1 = 0.f;
        if (!(keep & 4u)) p2 = 0.f;
        if (!(keep & 8u)) p3 = 0.f;
      }
      pf[j >> 1][2 * (j & 1)] = pack_bf16(p0, p1);
      pf[j >> 1][2 * (j & 1) + 1] = pack_bf16(p2, p3);
    }
    mma_tn<NT / 2, W>(o, pf, vs[stage], 0, lane);

    __syncthreads();  // every warp is done with this stage
    tile = next;
    stage ^= 1;
  }

  l0 += __shfl_xor_sync(kFullWarp, l0, 1);
  l0 += __shfl_xor_sync(kFullWarp, l0, 2);
  l1 += __shfl_xor_sync(kFullWarp, l1, 1);
  l1 += __shfl_xor_sync(kFullWarp, l1, 2);
  const float inv_keep = kDrop ? drop.inv_keep : 1.f;
  store_acc<W>(out + head + (int64_t)row0 * HD, HD, o, inv_keep / l0,
               inv_keep / l1, D, g, tq);
  if (stats != nullptr && tq == 0) {
    float2* st = stats + (int64_t)bh * L + row0 + g;
    st[0] = make_float2(m0, l0);
    st[8] = make_float2(m1, l1);
  }
}

template <int W>
constexpr int fwd_tc_shared_bytes() {
  return 4 * tile_bytes<W>() + 2 * kTcTile * (int)sizeof(int32_t);
}

// float32 takes the exact kernel, bfloat16 the tensor-core kernel, both at
// width W for head dim D.
template <typename T, int W, bool kDrop, bool kCausal>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int32_t* mask, void* out, void* stats,
                       Dropout drop, int B, int L, int H, int D, float scale,
                       cudaStream_t stream) {
  if (kernel_width(D) != W) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    if (L % kBQ != 0) return cudaErrorInvalidValue;
    attention_fwd_exact<float, W, kDrop, kCausal>
        <<<dim3(L / kBQ, H, B), kBQ, 0, stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), mask, static_cast<float*>(out),
            static_cast<float2*>(stats), drop, L, H, D, scale);
  } else {
    if (L % kTcTile != 0) return cudaErrorInvalidValue;
    constexpr int bytes = fwd_tc_shared_bytes<W>();
    auto kernel = &attention_fwd_tc<W, kDrop, kCausal>;
    const cudaError_t err = allow_shared(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(L / kTcRows, H, B), kTcThreads, bytes, stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), mask, static_cast<bf16*>(out),
            static_cast<float2*>(stats), drop, L, H, D, scale, nullptr);
  }
  return cudaGetLastError();
}

// The tensor-core kernel under a packed (B, L, L) admission mask `admit`
// (B, L / 64, L, 2) words, with kDrop its packed keep bits `keep` (B, H,
// L / 64, L, 2) scaled by drop.inv_keep (mask3d_attention.cu).
template <int W, bool kDrop>
cudaError_t launch_fwd_bits(const void* q, const void* k, const void* v,
                            const uint32_t* admit, const uint32_t* keep,
                            void* out, void* stats, Dropout drop, int B, int L,
                            int H, int D, float scale, cudaStream_t stream) {
  if (kernel_width(D) != W || L % kTcTile != 0 || admit == nullptr ||
      (kDrop && keep == nullptr)) {
    return cudaErrorInvalidValue;
  }
  constexpr int bytes = fwd_tc_shared_bytes<W>();
  auto kernel = &attention_fwd_tc<W, kDrop, false, true>;
  const cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(L / kTcRows, H, B), kTcThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), reinterpret_cast<const int32_t*>(admit),
      static_cast<bf16*>(out), static_cast<float2*>(stats), drop, L, H, D, scale,
      keep);
  return cudaGetLastError();
}

}  // namespace
