// The grouped beam decode's self-attention, one decode step, for Hopper
// (sm_90a): scores, scale, ancestry bias, softmax and context in one launch.
//
// Replaces no TPU kernel: the JAX package computes this step with XLA (its
// Pallas decode-attention kernel was deleted), and the port's plain version
// (ops/decode_attention.py::grouped_decode_attention_reference, the CPU path
// and the oracle) is two batched products around five elementwise passes
// over the (Bex, H, G, W*G) scores. Here those scores never reach device
// memory.
//
// Shapes. q: (Bex*H, G, D), one (example, head) pair's G beams as query
// rows. cache_k, cache_v: the row-stable cache (Bex, H, D, T*G), keys last,
// read in place through the prefix [..., :WG] (row stride T*G). bias:
// (Bex, G, WG) f32, the additive 0 / -1e9 table of inference/beam.py::
// ancestor_bias, shared by an example's heads. out: (Bex*H, G, D).
//
// Numerics, those of the plain version: q.k summed in f32, rounded to bf16
// when the scores are stored in the compute dtype (`round_scores`), then
// `* scale` and `+ bias` as two separately rounded f32 operations; softmax
// statistics in f32; the probabilities rounded to bf16 meet V with f32
// accumulation; the context rounded to the output dtype. The softmax is
// online (flash-style): the probabilities are rounded before the
// normalisation instead of after it, their precision unchanged.
//
// Bound: bytes. The K and V prefixes are all the data the step needs:
// 2 * Bex * H * D * WG * 2 bytes (315 MB for 32 x 12 heads of 64 at
// WG = 3,200), 94 us at 3.35 TB/s; the products are 4 * Bex * H * G * WG * D
// FLOP (6.3 G there), 6 us at the bf16 tensor-core peak. The bias (80 bytes
// a key an example) is read by an example's 12 heads at about the same time
// (the grid puts them next to each other), so it comes from HBM once.
//
// Design (bf16, `grouped_decode_attn_mma`): a block takes one (example,
// head) pair, up to 32 query rows (MT = two m16 tiles of `mma.sync`
// m16n8k16; G = 15 takes one), and a contiguous run of key tiles of 64,
// with 4 x MT warps: a warp takes one m16 tile and 16 keys of every tile
// and keeps its own running max, sum and 16 x D context in registers; the
// four key slices are merged at the end. Eight warps over 32 rows, rather
// than four warps of two tiles each, halve each warp's serial work a tile
// (the last window's 0.205 -> 0.153 ms on an H100). K and V tiles stream
// through a four-stage `cp.async` ring in 16-byte chunks. K
// is keys-last, so it is the B operand of q k^T in "row" layout
// (`ldmatrix.trans`); V, keys-last too, is directly the "col" B operand of
// p v. One block takes a pair's whole key axis: at the serving cells'
// 384 pairs, splitting it over blocks measured slower at every window
// (0.169-0.180 ms at 2-4 splits against 0.153 at retro's last window).
//
// Head dims up to 128: the kernel is built at widths 32, 64 and 128 and
// takes the least that holds D; the Q rows and the K and V tiles hold
// zeros in the columns past D, which add nothing to a score and give
// context columns that are not written.
//
// Masked key tiles are not read. A key whose bias is the mask value -1e9
// in every row has weight exp(-1e9 + s - max) = 0 exactly in f32 wherever
// the row admits another key, which ancestor_bias guarantees (position 0
// is admitted in every row), so a tile of such keys adds exactly nothing:
// every tile's bias is voted on (one barrier) before its K and V are
// fetched, and a tile that every row masks is skipped. The vote reads the
// bias from registers loaded two issues earlier: one issue earlier, each
// step's barrier waited on that load. In the decode the skipped tiles are
// each window's positions at or past the current length, about a quarter
// of the bytes at retro's window plan. A block always reads its first
// tile, so no row of it is empty.
//
// float32 (`grouped_decode_attn_exact`): the exact FMA route, chosen by the
// element type alone: plain loads into shared memory, one thread a key for
// the scores (eight interleaved sums over D, added pairwise), f32 softmax
// and context, the same masked-tile skip; any head dim up to 128. The
// running sum and context are compensated (Kahan) across the key tiles, so
// that a long key axis in one block adds no rounding of its own.
//
// Kernel names must not contain the benchmark's port-kernel fragments
// (portbench/trace.py::PORT_KERNELS): a traced run matches those against
// the other wrappers' counters.

#include <algorithm>

#include "attention_mma.cuh"

namespace {

constexpr int kThreads = 128;                // four warps (bf16: an m16 tile's)
constexpr int kStages = 4;                   // bf16: tiles in the ring
constexpr int kAhead = 2;                    // bf16: bias tiles fetched ahead
constexpr int kKeys = 64;                    // bf16: keys a tile, 16 a warp
constexpr int kKeyStride = kKeys + kPad;     // bf16 elements a K / V tile row
constexpr int kBiasStride = kKeys + 8;       // f32 a bias tile row
constexpr int kExactRows = 32;               // f32: query rows a block
constexpr int kExactKeys = 32;               // f32: keys a tile, one a lane
constexpr int kExactStride = kExactKeys + 1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* out;
  int64_t row_stride;  // elements between two D rows of the cache (T * G)
  int H, G, D, WG;
  int row_groups;  // ceil(G / R)
  int tiles;       // key tiles of the whole WG
  int vec;         // 16-byte copies: aligned cache rows and bias, WG % 8 == 0
  int qvec;        // 16-byte Q rows: aligned q, D % 8 == 0
  int round_scores;
  float scale;
};

// Block -> (example, head, row group). Heads vary fastest, so the heads of
// one example's bias run side by side.
struct Unit {
  int b, pair, rg;
};

__device__ __forceinline__ Unit unit_of(const Params& p) {
  const int h = blockIdx.x % p.H;
  Unit u;
  u.rg = blockIdx.x / p.H % p.row_groups;
  u.b = blockIdx.x / p.H / p.row_groups;
  u.pair = u.b * p.H + h;
  return u;
}

__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

// The score as the plain version forms it: rounded to bf16 when stored so,
// scaled, then biased, each step rounded on its own.
__device__ __forceinline__ float biased_score(float acc, float scale, float bias,
                                              int round_scores) {
  if (round_scores) acc = __bfloat162float(__float2bfloat16_rn(acc));
  return __fadd_rn(__fmul_rn(acc, scale), bias);
}

// Context rows 0 .. rows - 1 of a block into out (row stride D): the
// unnormalised rows o (row stride o_stride) over their sums l.
template <typename T>
__device__ void store_rows(const Params& p, const Unit& u, int R, int rows, const float* l,
                           const float* o, int o_stride) {
  const int D = p.D;
  T* out = static_cast<T*>(p.out) + ((int64_t)u.pair * p.G + u.rg * R) * D;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    store_out(out + i, o[r * o_stride + d] / l[r]);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores

// The width a bf16 block is built at for head dim D: 32, 64 or 128.
inline int mma_width(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : 128; }

// Query rows a bf16 block takes: 16 * MT.
inline int mma_tiles(int DW, int G) { return DW <= 64 && G > 16 ? 2 : 1; }

inline size_t mma_smem(int D, int MT, int rows) {
  return (size_t)16 * MT * (D + kPad) * sizeof(bf16) +
         (size_t)kStages * (2 * D * kKeyStride * sizeof(bf16) + rows * kBiasStride * sizeof(float));
}

// D: the width (p.D, the head dim, up to it).
template <int D, int MT>
__global__ void __launch_bounds__(kThreads * MT, 2)
    grouped_decode_attn_mma(const Params p) {
  constexpr int R = 16 * MT;
  constexpr int THREADS = kThreads * MT;               // 4 key slices x MT
  constexpr int QS = D + kPad;                          // bf16 a Q row
  constexpr int KV = D * kKeyStride;                    // bf16 a K or V tile
  constexpr int BIAS_CHUNKS = R * (kKeys / 4) / THREADS;  // float4 a thread
  constexpr int KV_CHUNKS = D * (kKeys / 8) / THREADS;    // 16-byte chunks
  extern __shared__ __align__(16) unsigned char smem[];
  const int HD = p.D;  // the head dim: columns HD .. D - 1 are zeros

  const Unit u = unit_of(p);
  const int rows = min(R, p.G - u.rg * R);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int slice = warp & 3, mt = warp >> 2;  // keys 16 slice .., rows 16 mt ..
  const int row0 = 16 * mt + g;                // this lane's rows: row0, row0 + 8
  // the upper half of the warp's rows holds no query row (G = 20: rows 24-31)
  const bool upper = row0 - g + 8 < rows;
  const int stage_bytes = 2 * KV * (int)sizeof(bf16) + rows * kBiasStride * (int)sizeof(float);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + R * QS * sizeof(bf16);

  const bf16* kbase = static_cast<const bf16*>(p.k) + (int64_t)u.pair * HD * p.row_stride;
  const bf16* vbase = static_cast<const bf16*>(p.v) + (int64_t)u.pair * HD * p.row_stride;
  const float* bbase = p.bias + ((int64_t)u.b * p.G + u.rg * R) * p.WG;
  const bf16* qbase = static_cast<const bf16*>(p.q) + ((int64_t)u.pair * p.G + u.rg * R) * HD;

  const int n = p.tiles;

  // the bias of the tiles to issue next, in registers, kAhead of them:
  // chunk c = tid + THREADS i is row c / 16, keys 4 (c % 16) .. + 3; -inf
  // where there is no key
  float nb[kAhead][BIAS_CHUNKS][4];
  auto fetch_bias = [&](int j, float (&dst)[BIAS_CHUNKS][4]) {
    const int key0 = j * kKeys;
#pragma unroll
    for (int i = 0; i < BIAS_CHUNKS; ++i) {
      const int c = tid + THREADS * i, r = c >> 4, key = key0 + 4 * (c & 15);
      dst[i][0] = dst[i][1] = dst[i][2] = dst[i][3] = -INFINITY;
      if (j < n && r < rows) {
        const float* src = bbase + (int64_t)r * p.WG + key;
        if (p.vec) {
          if (key < p.WG) {
            const float4 b4 = __ldg(reinterpret_cast<const float4*>(src));
            dst[i][0] = b4.x;
            dst[i][1] = b4.y;
            dst[i][2] = b4.z;
            dst[i][3] = b4.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (key + e < p.WG) dst[i][e] = __ldg(src + e);
          }
        }
      }
    }
  };

  // Tile j into stage j % kStages: its bias (from `b` when `voted`, else
  // straight from memory), K and V; one commit group either way. Keys past
  // WG read as zeros (their scores are set to -inf), as do the columns
  // past the head dim. With `voted`, the
  // block first votes on b (the barrier of the step), and a tile that
  // every row masks is neither fetched nor computed. Returns whether the
  // tile is live.
  auto issue = [&](int j, bool voted, const float (&b)[BIAS_CHUNKS][4]) -> bool {
    bool live = j < n;
    if (voted) {
      bool any = false;
#pragma unroll
      for (int i = 0; i < BIAS_CHUNKS; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) any |= b[i][e] > kMaskBias;
      }
      live = __syncthreads_or(any) != 0;
    }
    if (live) {
      const int st = j % kStages;
      bf16* kt = reinterpret_cast<bf16*>(ring + st * stage_bytes);
      bf16* vt = kt + KV;
      float* bt = reinterpret_cast<float*>(vt + KV);
      const int key0 = j * kKeys;
#pragma unroll
      for (int i = 0; i < BIAS_CHUNKS; ++i) {
        const int c = tid + THREADS * i, r = c >> 4, cc = c & 15, key = key0 + 4 * cc;
        if (r >= rows) continue;
        float* dst = bt + r * kBiasStride + 4 * cc;
        if (voted) {
          *reinterpret_cast<float4*>(dst) = make_float4(b[i][0], b[i][1], b[i][2], b[i][3]);
        } else if (p.vec) {
          cp_async16_or_zero(dst, bbase + (int64_t)r * p.WG + (key < p.WG ? key : 0),
                             key >= p.WG);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dst[e] = key + e < p.WG ? __ldg(bbase + (int64_t)r * p.WG + key + e) : 0.f;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < KV_CHUNKS; ++i) {
        const int c = tid + THREADS * i, d = c >> 3, cc = c & 7, key = key0 + 8 * cc;
        const int64_t row = (int64_t)(d < HD ? d : 0) * p.row_stride;
        bf16* kd = kt + d * kKeyStride + 8 * cc;
        bf16* vd = vt + d * kKeyStride + 8 * cc;
        if (p.vec) {
          const bool outside = key >= p.WG || d >= HD;
          const int64_t off = row + (outside ? 0 : key);
          cp_async16_or_zero(kd, kbase + off, outside);
          cp_async16_or_zero(vd, vbase + off, outside);
        } else {
          const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const bool in = d < HD && key + e < p.WG;
            kd[e] = in ? kbase[row + key + e] : zero;
            vd[e] = in ? vbase[row + key + e] : zero;
          }
        }
      }
    }
    cp_async_commit();
    return live;
  };

  // this warp's rows (row0, row0 + 8) over its key slice: running max and
  // sum (a lane's part of the row's sum), context
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  // Tile i: the warp's 16 keys of it into its rows' running max, sum and
  // context.
  auto compute = [&](int i) {
    const bf16* kt = reinterpret_cast<const bf16*>(ring + (i % kStages) * stage_bytes);
    const bf16* vt = kt + KV;
    const float* bt = reinterpret_cast<const float*>(vt + KV);
    const int kw = 16 * slice;                    // this warp's keys in the tile
    const int key_w = i * kKeys + kw;

    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];  // keys kw .. kw + 7 (b[0], b[1]) and kw + 8 .. kw + 15
      ldmatrix_x4_trans(b, kt + (16 * kk + (lane & 15)) * kKeyStride + kw + 8 * (lane >> 4));
      uint32_t a[4];
      ldmatrix_x4(a, qs + (16 * mt + (lane & 15)) * QS + 16 * kk + 8 * (lane >> 4));
      mma_bf16(s[0], a, b[0], b[1]);
      mma_bf16(s[1], a, b[2], b[3]);
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (hf == 1 && !upper) {
        s[0][2] = s[0][3] = s[1][2] = s[1][3] = 0.f;  // weights 0: no row
        continue;
      }
      const int row = row0 + 8 * hf;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int key = 8 * nt + 2 * tq;
        const float2 b2 = row < rows
                              ? *reinterpret_cast<const float2*>(bt + row * kBiasStride + kw + key)
                              : make_float2(0.f, 0.f);
        float x0 = biased_score(s[nt][2 * hf], p.scale, b2.x, p.round_scores);
        float x1 = biased_score(s[nt][2 * hf + 1], p.scale, b2.y, p.round_scores);
        if (key_w + key >= p.WG) x0 = -INFINITY;
        if (key_w + key + 1 >= p.WG) x1 = -INFINITY;
        s[nt][2 * hf] = x0;
        s[nt][2 * hf + 1] = x1;
        mx = fmaxf(mx, fmaxf(x0, x1));
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFullWarp, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFullWarp, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = __expf(m[hf] - m_use);
      m[hf] = m_new;
      l[hf] *= alpha;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        o[nd][2 * hf] *= alpha;
        o[nd][2 * hf + 1] *= alpha;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float p0 = __expf(s[nt][2 * hf] - m_use);
        const float p1 = __expf(s[nt][2 * hf + 1] - m_use);
        l[hf] += p0 + p1;
        s[nt][2 * hf] = p0;
        s[nt][2 * hf + 1] = p1;
      }
    }
    // the weights as the A fragment of p v
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t b[4];  // D rows 16 n2 .. + 7 (b[0], b[1]) and + 8 .. + 15
      ldmatrix_x4(b, vt + (16 * n2 + (lane & 7) + 8 * (lane >> 4)) * kKeyStride + kw +
                         8 * ((lane >> 3) & 1));
      mma_bf16(o[2 * n2], pa, b[0], b[1]);
      mma_bf16(o[2 * n2 + 1], pa, b[2], b[3]);
    }
  };

  // The ring's first tiles are fetched without a vote: they begin the
  // block's run, where a decode's live keys are. Then each step waits for
  // tile i, votes on tile i + kStages - 1 and issues it, fetches the bias
  // of the tile kAhead issues later, and computes tile i. The steps are
  // unrolled by kAhead so that each bias buffer is a fixed set of
  // registers.
  uint32_t live = 0;  // bit j % kStages: tile j is live
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) live |= (uint32_t)issue(j, false, nb[0]) << j;
#pragma unroll
  for (int a = 0; a < kAhead; ++a) fetch_bias(kStages - 1 + a, nb[a]);
  if (p.qvec) {
    for (int c = tid; c < R * D / 8; c += THREADS) {
      const int r = c / (D / 8), cc = c % (D / 8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && 8 * cc < HD) val = *reinterpret_cast<const uint4*>(qbase + r * HD + 8 * cc);
      *reinterpret_cast<uint4*>(qs + r * QS + 8 * cc) = val;
    }
  } else {
    for (int c = tid; c < R * D; c += THREADS) {
      const int r = c / D, d = c % D;
      qs[r * QS + d] = r < rows && d < HD ? qbase[r * HD + d] : __float2bfloat16_rn(0.f);
    }
  }

  for (int i0 = 0; i0 < n; i0 += kAhead) {
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int i = i0 + a;
      if (i >= n) break;
      cp_async_wait<kStages - 2>();
      const int j = i + kStages - 1;
      const bool lj = issue(j, true, nb[a]);  // the step's barrier: tile i is in
      live = (live & ~(1u << (j % kStages))) | ((uint32_t)lj << (j % kStages));
      fetch_bias(j + kAhead, nb[a]);
      if ((live >> (i % kStages)) & 1u) compute(i);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the four key slices' rows, merged: [slice][R] max and sum, [slice][R][D]
  float* wm = reinterpret_cast<float*>(ring);
  float* wl = wm + 4 * R;
  float* wo = wl + 4 * R;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + 8 * hf;
    float sum = l[hf];
    sum += __shfl_xor_sync(kFullWarp, sum, 1);
    sum += __shfl_xor_sync(kFullWarp, sum, 2);
    if (tq == 0) {
      wm[slice * R + row] = m[hf];
      wl[slice * R + row] = sum;
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<float2*>(wo + (slice * R + row) * D + 8 * nd + 2 * tq) =
          make_float2(o[nd][2 * hf], o[nd][2 * hf + 1]);
    }
  }
  __syncthreads();
  // rows' merged statistics, then each (row, d) of the context, written
  // past the slices' parts
  float* bm = wo + 4 * R * D;
  float* bl = bm + R;
  float* bo = bl + R;  // [rows][HD]
  for (int r = tid; r < rows; r += THREADS) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, wm[w * R + r]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) L += wl[w * R + r] * __expf(wm[w * R + r] - M);
    bm[r] = M;
    bl[r] = L;
  }
  __syncthreads();
  for (int i = tid; i < rows * HD; i += THREADS) {
    const int r = i / HD, d = i - r * HD;
    float O = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) O += wo[(w * R + r) * D + d] * __expf(wm[w * R + r] - bm[r]);
    bo[i] = O;
  }
  __syncthreads();
  store_rows<bf16>(p, u, R, rows, bl, bo, HD);
}

// ---------------------------------------------------------------------------
// float32: exact FMAs

// sum = sum * alpha + x, compensated (Kahan): c holds what the running sum
// lost, so that sum - c is the total. Each step rounded on its own.
__device__ __forceinline__ void kahan_add(float& sum, float& c, float alpha, float x) {
  sum = __fmul_rn(sum, alpha);
  c = __fmul_rn(c, alpha);
  const float y = __fsub_rn(x, c);
  const float t = __fadd_rn(sum, y);
  c = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

inline size_t exact_smem(int D) {
  return sizeof(float) * ((size_t)kExactRows * D + 2 * (size_t)D * kExactStride +
                          2 * kExactRows * kExactStride + 2 * kExactRows);
}

__global__ void __launch_bounds__(kThreads) grouped_decode_attn_exact(const Params p) {
  constexpr int R = kExactRows, NK = kExactKeys, KS = kExactStride;
  constexpr int ROWS_A_WARP = R / 4;
  constexpr int MAX_OUT = R * 128 / kThreads;  // context elements a thread at D = 128
  extern __shared__ float fsm[];
  const int D = p.D;
  float* qs = fsm;              // [R][D]
  float* ks = qs + R * D;       // [D][KS]
  float* vs = ks + D * KS;      // [D][KS]
  float* ws_ = vs + D * KS;     // [R][KS] weights
  float* bs = ws_ + R * KS;     // [R][KS] bias
  float* alpha_s = bs + R * KS; // [R]
  float* ls = alpha_s + R;      // [R]

  const Unit u = unit_of(p);
  const int rows = min(R, p.G - u.rg * R);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* kbase = static_cast<const float*>(p.k) + (int64_t)u.pair * D * p.row_stride;
  const float* vbase = static_cast<const float*>(p.v) + (int64_t)u.pair * D * p.row_stride;
  const float* bbase = p.bias + ((int64_t)u.b * p.G + u.rg * R) * p.WG;
  const float* qbase = static_cast<const float*>(p.q) + ((int64_t)u.pair * p.G + u.rg * R) * D;
  for (int i = tid; i < R * D; i += kThreads) qs[i] = i / D < rows ? qbase[i] : 0.f;

  const int n = p.tiles;

  // rows warp + 4 j, the same in every lane: max, sum and the sum's
  // compensation
  float m[ROWS_A_WARP], l[ROWS_A_WARP], lc[ROWS_A_WARP];
#pragma unroll
  for (int j = 0; j < ROWS_A_WARP; ++j) {
    m[j] = -INFINITY;
    l[j] = lc[j] = 0.f;
  }
  float o[MAX_OUT], oc[MAX_OUT];  // context element tid + 128 j, compensation
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) o[j] = oc[j] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int key0 = i * NK;
    bool any = i == 0;
    for (int e = tid; e < R * NK; e += kThreads) {
      const int r = e / NK, kk = e % NK;
      float b = 0.f;
      if (r < rows && key0 + kk < p.WG) {
        b = __ldg(bbase + (int64_t)r * p.WG + key0 + kk);
        any |= b > kMaskBias;
      }
      bs[r * KS + kk] = b;
    }
    if (!__syncthreads_or(any)) continue;
    for (int e = tid; e < D * NK; e += kThreads) {
      const int d = e / NK, kk = e % NK;
      const bool in = key0 + kk < p.WG;
      const int64_t off = (int64_t)d * p.row_stride + key0 + kk;
      ks[d * KS + kk] = in ? kbase[off] : 0.f;
      vs[d * KS + kk] = in ? vbase[off] : 0.f;
    }
    __syncthreads();
    // scores of rows warp + 4 j at key `lane`, and their online softmax
    const bool key_in = key0 + lane < p.WG;
#pragma unroll
    for (int j = 0; j < ROWS_A_WARP; ++j) {
      const int r = warp + 4 * j;
      // q.k in eight interleaved f32 sums, added pairwise
      float a8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      int d = 0;
      for (; d + 8 <= D; d += 8) {
#pragma unroll
        for (int e = 0; e < 8; ++e) a8[e] = fmaf(qs[r * D + d + e], ks[(d + e) * KS + lane], a8[e]);
      }
      for (; d < D; ++d) a8[0] = fmaf(qs[r * D + d], ks[d * KS + lane], a8[0]);
      const float acc = ((a8[0] + a8[1]) + (a8[2] + a8[3])) + ((a8[4] + a8[5]) + (a8[6] + a8[7]));
      const float x = key_in ? biased_score(acc, p.scale, bs[r * KS + lane], p.round_scores)
                             : -INFINITY;
      float mx = x;
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFullWarp, mx, sh));
      const float m_new = fmaxf(m[j], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[j] - m_use);
      const float pw = expf(x - m_use);
      float sum = pw;
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) sum += __shfl_xor_sync(kFullWarp, sum, sh);
      m[j] = m_new;
      kahan_add(l[j], lc[j], alpha, sum);
      ws_[r * KS + lane] = pw;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAX_OUT; ++j) {
      const int e = tid + kThreads * j;
      if (e < R * D) {
        const int r = e / D, d = e - r * D;
        float tile = 0.f;  // the tile's own sum
        for (int kk = 0; kk < NK; ++kk) tile = fmaf(ws_[r * KS + kk], vs[d * KS + kk], tile);
        kahan_add(o[j], oc[j], alpha_s[r], tile);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < ROWS_A_WARP; ++j) ls[warp + 4 * j] = __fsub_rn(l[j], lc[j]);
  }
  __syncthreads();
  // the context rows, through shared memory (the K tile's room)
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) {
    const int e = tid + kThreads * j;
    if (e < R * D) qs[e] = __fsub_rn(o[j], oc[j]);
  }
  __syncthreads();
  store_rows<float>(p, u, R, rows, ls, qs, D);
}

// ---------------------------------------------------------------------------

template <int D, int MT>
cudaError_t launch_mma(const Params& p, int blocks, cudaStream_t stream) {
  const size_t smem = mma_smem(D, MT, std::min(16 * MT, p.G));
  auto* kernel = grouped_decode_attn_mma<D, MT>;
  cudaError_t err = allow_shared(kernel, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads * MT, smem, stream>>>(p);
  return cudaGetLastError();
}

#define TR_DECODE_MMA(CALL)                                              \
  do {                                                                   \
    const int DW = mma_width(D), MT = mma_tiles(DW, G);                  \
    if (DW == 64) return MT == 2 ? CALL(64, 2) : CALL(64, 1);            \
    if (DW == 32) return MT == 2 ? CALL(32, 2) : CALL(32, 1);            \
    return CALL(128, 1);                                                 \
  } while (0)

}  // namespace

extern "C" {

// q: (Bex*H, G, D) contiguous; k, v: (Bex, H, D, row_stride) contiguous,
// keys 0 .. WG - 1 of each row read; bias: (Bex, G, WG) float32
// contiguous; out: (Bex*H, G, D); D from 1 to 128. Returns
// cudaGetLastError() after the launch.
int tr_grouped_decode_attn(int dtype, const void* q, const void* k, const void* v,
                           const void* bias, void* out, int Bex, int H, int G, int D,
                           int WG, int64_t row_stride, float scale, int round_scores,
                           void* stream) {
  if (Bex == 0 || H == 0 || G == 0) return 0;
  if (WG <= 0 || D <= 0 || D > 128) return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.row_stride = row_stride;
  p.H = H;
  p.G = G;
  p.D = D;
  p.WG = WG;
  p.round_scores = round_scores;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    p.row_groups = (G + kExactRows - 1) / kExactRows;
    p.tiles = (WG + kExactKeys - 1) / kExactKeys;
    p.vec = p.qvec = 0;
    const int smem = (int)exact_smem(D);
    cudaError_t err = allow_shared(grouped_decode_attn_exact, smem);
    if (err != cudaSuccess) return err;
    grouped_decode_attn_exact<<<Bex * H * p.row_groups, kThreads, smem, st>>>(p);
    return cudaGetLastError();
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const int R = 16 * mma_tiles(mma_width(D), G);
  p.row_groups = (G + R - 1) / R;
  p.tiles = (WG + kKeys - 1) / kKeys;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(bias);
  p.vec = addr % 16 == 0 && row_stride % 8 == 0 && WG % 8 == 0;
  p.qvec = reinterpret_cast<uintptr_t>(q) % 16 == 0 && D % 8 == 0;
  const int blocks = Bex * H * p.row_groups;
#define TR_LAUNCH(DD, MM) launch_mma<DD, MM>(p, blocks, st)
  TR_DECODE_MMA(TR_LAUNCH);
#undef TR_LAUNCH
}

const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
