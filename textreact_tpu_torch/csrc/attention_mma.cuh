// Building blocks of the bf16 tensor-core attention kernels
// (attention_fwd.cuh, attention_bwd.cuh): asynchronous 16-byte copies of a
// head's D columns into padded shared-memory tiles of the instantiated width
// W, `ldmatrix` fragment loads, the
// `mma.sync.aligned.m16n8k16` bf16 product with f32 accumulation, the scan
// that finds the key tiles worth visiting, and the dropout bits in the
// product's accumulator layout with every word of a Philox draw used.
//
// Fragment layouts of m16n8k16 (PTX ISA, "Matrix fragments for mma.m16n8k16
// with floating point type"), for lane = 4 * g + t of a warp:
//   A (16 x 16, row major), four registers of two bf16:
//     a0 = (row g, k 2t..2t+1)      a1 = (row g + 8, k 2t..2t+1)
//     a2 = (row g, k 2t+8..2t+9)    a3 = (row g + 8, k 2t+8..2t+9)
//   B (16 x 8, "col"), two registers: b0 = (k 2t..2t+1, n g), b1 = (k
//     2t+8..2t+9, n g)
//   C, D (16 x 8), four f32: c0 = (row g, n 2t), c1 = (row g, n 2t+1),
//     c2 = (row g + 8, n 2t), c3 = (row g + 8, n 2t+1).
// Two neighbouring 16 x 8 accumulator tiles, rounded to bf16, are therefore
// one A fragment of the next product (c0,c1 | c2,c3 | c0',c1' | c2',c3'), so
// the softmax weights and dS go from one product into the next in registers.

#pragma once

#include "attention_common.cuh"

namespace {

constexpr int kTcThreads = 128;  // four warps
constexpr int kTcRows = 64;      // rows of the block's own tile, 16 a warp
constexpr int kTcTile = 64;      // rows of a streamed tile
// A tile's row is W bf16 = 256, 128 or 64 bytes. Stored at that stride, the eight
// rows an `ldmatrix` reads would share their banks; eight more elements (16
// bytes) a row shift each row by four banks, so the eight 16-byte reads of
// one 8 x 8 matrix cover all 32 banks once.
constexpr int kPad = 8;
constexpr uint32_t kFullWarp = 0xffffffffu;

using bf16 = __nv_bfloat16;

// Bytes of one padded tile [kTcTile][W + kPad] of bf16.
template <int W>
constexpr int tile_bytes() {
  return kTcTile * (W + kPad) * (int)sizeof(bf16);
}

// The tensor-core kernels take their shared memory dynamically (carved from
// `tc_smem`): at D = 128 their stages outgrow the 48 KB that a block may
// declare statically, and past those 48 KB a kernel must ask for more.
template <typename Kernel>
cudaError_t allow_shared(Kernel* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b on the tensor cores: 16 x 16 bf16 by 16 x 8 bf16 into 16 x 8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (round to nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// cp_async16, or, with `zero`, 16 bytes of zeros and no read (the
// `ignore-src` predicate of cp.async; src must still be a valid address).
__device__ __forceinline__ void cp_async16_or_zero(void* dst, const void* src,
                                                   bool zero) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "cp.async.cg.shared.global [%0], [%1], 16, p;\n}\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"((int)zero)
      : "memory");
}

// Start the copy of 64 rows of one head (D bf16 each, row stride HD in
// global memory) into a padded shared-memory tile [64][W + kPad]: 16 bytes a
// thread a turn, W / 8 neighbouring threads on one row, so global memory is
// read in whole runs of 2 D bytes. Columns D .. W - 1 get zeros: a thread
// copies the same chunk of every row it takes, and a chunk past D is a copy
// that ignores its source (the row's last chunk below D, a valid address)
// and writes zeros, so every stage holds zeros there and the products at
// width W equal, to the bit, those over inputs zero-padded to W in device
// memory (the Philox coordinates hold no D, so the dropout bits are those
// too). Zeroing the columns once a block instead, with the copies skipping
// them, needs a test in this loop, and on an H100 a test a chunk (the
// address arithmetic no longer hoisted) and a test a call (the loop no
// longer straight-line code) each left the W = 128 forward slower than
// before at D = W; a copy of source size 0 kept its time but held one more
// register in every kernel. The predicate costs an issue slot a chunk, no
// memory traffic and no register.
template <int W>
__device__ __forceinline__ void copy_tile_async(bf16* dst, const bf16* src,
                                                int64_t HD, int D, int t) {
  constexpr int C = W / 8;  // 16-byte chunks per row of the tile
  static_assert(kTcThreads % C == 0, "a thread's chunk is the same in every row");
  const bool outside = 8 * (t % C) >= D;
  const int col = outside ? D - 8 : 8 * (t % C);
#pragma unroll
  for (int n = 0; n < kTcTile * C / kTcThreads; ++n) {
    const int i = t + n * kTcThreads;
    const int r = i / C;
    const int c = i % C;
    cp_async16_or_zero(dst + r * (W + kPad) + 8 * c, src + (int64_t)r * HD + col, outside);
  }
}

// A fragments of rows row0 .. row0 + 15 of a tile [row][W + kPad].
template <int W>
__device__ __forceinline__ void load_a(uint32_t (&a)[W / 16][4], const bf16* tile,
                                       int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    ldmatrix_x4(a[kk], tile + (row0 + (lane & 15)) * (W + kPad) + 16 * kk +
                           8 * (lane >> 4));
  }
}

// acc (16 x 8 NT) += A (16 x W) B^T, B the rows row0 .. row0 + 8 NT - 1 of a
// tile [row][W + kPad]: the products q k^T, dO v^T and their transposes.
template <int NT, int W>
__device__ __forceinline__ void mma_nt(float (&acc)[NT][4],
                                       const uint32_t (&a)[W / 16][4],
                                       const bf16* tile, int row0, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int k2 = 0; k2 < W / 32; ++k2) {
      uint32_t b[4];  // B fragments of two k-steps of 16
      ldmatrix_x4(b, tile + (row0 + 8 * j + (lane & 7)) * (W + kPad) + 32 * k2 +
                         8 * (lane >> 3));
      mma_bf16(acc[j], a[2 * k2], b[0], b[1]);
      mma_bf16(acc[j], a[2 * k2 + 1], b[2], b[3]);
    }
  }
}

// acc (16 x W) += A (16 x 16 KS, from registers) B, B the rows row0 .. row0 +
// 16 KS - 1 of a tile [row][W + kPad], read transposed: the products p v,
// dS k, p^T dO and dS^T q.
template <int KS, int W>
__device__ __forceinline__ void mma_tn(float (&acc)[W / 8][4],
                                       const uint32_t (&a)[KS][4],
                                       const bf16* tile, int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int n2 = 0; n2 < W / 16; ++n2) {
      uint32_t b[4];  // B fragments of two n-tiles of 8
      ldmatrix_x4_trans(b, tile + (row0 + 16 * kk + (lane & 15)) * (W + kPad) +
                               16 * n2 + 8 * (lane >> 4));
      mma_bf16(acc[2 * n2], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * n2 + 1], a[kk], b[2], b[3]);
    }
  }
}

// Write columns 0 .. D - 1 of a warp's 16 x W accumulator, row g scaled by r0
// and row g + 8 by r1, as bf16 to `dst` (the address of the warp's row 0, row
// stride HD).
template <int W>
__device__ __forceinline__ void store_acc(bf16* dst, int64_t HD,
                                          const float (&acc)[W / 8][4], float r0,
                                          float r1, int D, int g, int tq) {
  bf16* p0 = dst + (int64_t)g * HD + 2 * tq;
  bf16* p1 = p0 + 8 * HD;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    if (8 * j < D) {
      *reinterpret_cast<uint32_t*>(p0 + 8 * j) = pack_bf16(acc[j][0] * r0, acc[j][1] * r0);
      *reinterpret_cast<uint32_t*>(p1 + 8 * j) = pack_bf16(acc[j][2] * r1, acc[j][3] * r1);
    }
  }
}

// Which key tiles of one batch row hold a valid key.
//
// A masked key's score is -1e9 + s. In a row whose running max comes from a
// valid key its weight exp(-1e9 + s - m) is exactly 0 in f32, so a key tile
// that is masked whole adds exactly nothing to the output, the statistics or
// any gradient, and a masked tile that comes first leaves only terms that the
// first valid tile's correction exp(-1e9 - m) = 0 wipes out: leaving such
// tiles out gives the same bits. That holds only where EVERY query row of the
// batch row sees a valid key: without the causal flag, when the batch row has
// one at all (a collator dummy row has none: its softmax is uniform over all
// keys and nothing is left out); with it, when key 0 is valid, the one key
// every row sees. `skip` says so; bit i of `valid` is key tile i. Rows of
// more than 64 tiles are not scanned.
struct KeyTiles {
  uint64_t valid;
  bool skip;
};

template <bool kCausal>
__device__ __forceinline__ KeyTiles scan_key_tiles(const int32_t* __restrict__ mrow,
                                                   int n_tiles, int lane) {
  KeyTiles kt;
  kt.valid = 0;
  kt.skip = false;
  if (mrow == nullptr || n_tiles > 64) return kt;
  for (int i = 0; i < n_tiles; ++i) {
    const int2 mm = *reinterpret_cast<const int2*>(mrow + i * kTcTile + 2 * lane);
    if (__any_sync(kFullWarp, mm.x > 0 || mm.y > 0)) kt.valid |= 1ull << i;
  }
  kt.skip = kCausal ? mrow[0] > 0 : kt.valid != 0;
  return kt;
}

// The first tile at or after `from` to visit, or `n` if there is none.
__device__ __forceinline__ int next_tile(const KeyTiles& kt, int from, int n) {
  if (!kt.skip || from >= n) return from < n ? from : n;
  const uint64_t rest = kt.valid >> from;  // n <= 64 here, so from < 64
  const int next = from + __ffsll((long long)rest) - 1;
  return rest != 0 && next < n ? next : n;
}

// Keep flags of this lane's four elements of a 16 x 8 accumulator tile of
// scores whose rows are queries and columns keys: bit e belongs to c[e],
// element (query row0 + g + 8 (e >> 1), key col0 + 2 t + (e & 1)), col0 a
// multiple of 8. A Philox draw yields the words of four neighbouring keys of
// one query, which lie in two lanes (t, t ^ 1); the tile's two rows of a
// quad need four draws, one a lane: the even lane draws row g, the odd lane
// row g + 8, and they exchange the two words the other one holds. Every word
// of every draw is used.
__device__ __forceinline__ uint32_t keep_bits(uint64_t seed, uint32_t threshold,
                                              uint32_t bh, int row0, int col0,
                                              int g, int tq) {
  const bool odd = tq & 1;
  uint32_t w[4];
  tr::attention_bits(seed, bh, (uint32_t)(row0 + g + (odd ? 8 : 0)),
                     (uint32_t)((col0 >> 2) + (tq >> 1)), w);
  // this lane's keys are words 0, 1 (even lane) or 2, 3 (odd lane)
  const uint32_t own0 = odd ? w[2] : w[0], own1 = odd ? w[3] : w[1];
  const uint32_t got0 = __shfl_xor_sync(kFullWarp, odd ? w[0] : w[2], 1);
  const uint32_t got1 = __shfl_xor_sync(kFullWarp, odd ? w[1] : w[3], 1);
  const uint32_t g0 = odd ? got0 : own0, g1 = odd ? got1 : own1;  // row g
  const uint32_t h0 = odd ? own0 : got0, h1 = odd ? own1 : got1;  // row g + 8
  return (uint32_t)(g0 >= threshold) | (uint32_t)(g1 >= threshold) << 1 |
         (uint32_t)(h0 >= threshold) << 2 | (uint32_t)(h1 >= threshold) << 3;
}

}  // namespace
