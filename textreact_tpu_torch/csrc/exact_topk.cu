// Exact top-k nearest neighbours in squared L2 distance over int8 vectors,
// fused with the selection, for Hopper (sm_90a).
//
// Replaces: textreact_tpu/ops/topk.py::exact_topk_l2 (Pallas TPU), both of
// its layouts: `topk_query_outer` stands for _topk_kernel (the query-outer
// grid) and `topk_corpus_split` + `topk_merge` for
// _topk_kernel_corpus_resident. Per query the function is the k smallest of
//   score(c) = |c|^2 - 2 q.c   (+ |q|^2, added after the selection)
// over corpus rows c, in (distance, index) order: of two equal distances the
// lower corpus index comes first, the FAISS-flat rule. A row whose norm is
// >= 2^30 (padding) and a row named in the query's banned ids never enter;
// a slot that no row filled comes back as (2^30 + |q|^2, 2^30). Everything
// is integer arithmetic: int8 products summed in int32 (|score| < 2^27 for
// d <= 2048), 64-bit keys (score << 32 | index) compared as signed
// integers. No float and no atomic, so the result is bit for bit that of a
// brute-force scan.
//
// Bound: operations. 2 * M * N * d integer operations against
// (N + M) * d bytes read once: at M = 8192 that is thousands of operations
// a byte, far above the card's balance point, so the floor is the tensor
// cores' int8 rate.
//
// Design. The products run on the tensor cores through
// mma.sync.m16n8k32 (s8 x s8 -> s32), written here as inline PTX. A block
// of 8 warps owns 128 queries and walks its share of the corpus in tiles of
// 128 rows, from the lowest index upward. For one tile, both operands
// stream through shared memory in slices of 128 bytes of d (cp.async, two
// stages, rows padded to 144 bytes so that a warp's 32-bit fragment loads
// touch 32 different banks); each warp accumulates a 64 x 32 piece of the
// 128 x 128 products in registers. The block then lays the products over
// the staging buffers, and each warp takes 16 of the queries: a lane reads
// four neighbouring columns of a row, forms the keys (banned and padding
// columns become a key that never passes) and tests them against the
// query's current k-th key. That test is the hot path: after the first
// tiles almost nothing passes. What passes is inserted, smallest key first,
// into the query's sorted list in shared memory by the whole warp (count
// the smaller entries with a ballot, shift the tail by one, write): the
// rare path, kept simple.
//
// The TPU's corpus-resident kernel keeps every query's running list in VMEM
// while each corpus tile is read once. The card has no such memory for
// thousands of queries, so `topk_corpus_split` cuts the corpus into S
// contiguous slabs over the grid's second dimension: block (query tile,
// slab) runs the same scan over its slab and writes its sorted partial list
// of keys into an (S, M, k) workspace, and `topk_merge` (one warp a query)
// merges the S lists in key order. That gives S times the blocks (the
// query-outer grid has only M / 128), and blocks that are scheduled
// together read the same slab, which then comes from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long key64;

constexpr int kTileQ = 128;              // queries a block
constexpr int kTileC = 128;              // corpus rows a tile
constexpr int kChunk = 128;              // bytes of d a pipeline stage
constexpr int kRowBytes = kChunk + 16;   // padded operand row: 36 words
constexpr int kStages = 2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kTileQ / kWarps;      // 16 queries a warp
constexpr int kOperandBytes = kTileQ * kRowBytes;  // one operand, one stage
constexpr int kStageBytes = 2 * kOperandBytes;
constexpr int kScoreStride = kTileC + 8;           // words a row of products
constexpr int kStagingBytes = kStages * kStageBytes;
constexpr int kMaxK = 128;
constexpr int kBig = 1 << 30;
constexpr int kMergeWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kTileQ == kTileC, "one loader serves both operands");
static_assert(kTileQ * kScoreStride * 4 <= kStagingBytes,
              "the products lie over the staging buffers");

__device__ __forceinline__ key64 make_key(int score, int index) {
  return (key64)(((unsigned long long)(unsigned)score << 32) | (unsigned)index);
}
constexpr key64 kEmptyKey = ((key64)kBig << 32) | (key64)kBig;  // an unfilled slot
constexpr key64 kNever = 0x7fffffffffffffffLL;                  // passes no test

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  // copies `bytes` (0 or 16) from src and fills the rest of the 16 with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// acc (16 x 8, s32) += a (16 x 32, s8, row-major) * b (32 x 8, s8, column-major)
__device__ __forceinline__ void mma_s8(int acc[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ key64 warp_min(key64 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const key64 o = __shfl_xor_sync(kFull, v, off);
    v = o < v ? o : v;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The whole warp inserts x (the same in every lane, smaller than lst[k - 1])
// into the ascending list lst[0..k): the last entry drops out.
__device__ __forceinline__ void warp_insert(key64* lst, int k, key64 x, int lane) {
  int pos = 0;
  for (int t0 = 0; t0 < k; t0 += 32) {
    const int t = t0 + lane;
    const bool smaller = t < k && lst[t] < x;
    pos += __popc(__ballot_sync(kFull, smaller));
  }
  // shift lst[pos..k-2] up by one, from the top chunk of 32 slots downward:
  // a chunk reads its left neighbours before any lane of it writes
  for (int t0 = ((k - 1) / 32) * 32; t0 >= 0 && t0 + 31 >= pos; t0 -= 32) {
    const int t = t0 + lane;
    const bool moves = t < k && t >= pos;
    key64 v = x;
    if (moves && t > pos) v = lst[t - 1];
    __syncwarp();
    if (moves) lst[t] = v;
    __syncwarp();
  }
}

// |q|^2 of one query row (d a multiple of 4), by the whole warp.
__device__ __forceinline__ int warp_sq_norm(const int8_t* row, int d, int lane) {
  const int* words = reinterpret_cast<const int*>(row);
  int acc = 0;
  for (int w = lane; w < d / 4; w += 32) {
    const int v = words[w];
    acc = __dp4a(v, v, acc);
  }
  return warp_sum(acc);
}

// One 128-byte slice of d of both operands into a stage: 2 x 128 rows of 8
// pieces of 16 bytes, 8 pieces a thread. Rows past the matrix and bytes past
// d arrive as zeros.
__device__ __forceinline__ void load_stage(unsigned char* stage,
                                           const int8_t* __restrict__ queries,
                                           const int8_t* __restrict__ corpus, int M,
                                           int c_end, int d, int q0, int c0, int kc,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < 2 * kTileQ * (kChunk / 16) / kThreads; ++i) {
    const int piece = tid + i * kThreads;
    const int operand = piece / (kTileQ * (kChunk / 16));
    const int p = piece % (kTileQ * (kChunk / 16));
    const int r = p / (kChunk / 16);
    const int seg = p % (kChunk / 16);
    const int koff = kc * kChunk + seg * 16;
    const int8_t* base = operand == 0 ? queries : corpus;
    const int row = (operand == 0 ? q0 : c0) + r;
    const bool valid = row < (operand == 0 ? M : c_end) && koff < d;
    const int8_t* src = valid ? base + (size_t)row * d + koff : base;
    cp_async16(stage + operand * kOperandBytes + r * kRowBytes + seg * 16, src,
               valid ? 16 : 0);
  }
}

// The running top-k of queries [q0, q0 + 128) over corpus rows
// [c_begin, c_end), left sorted in lists[query][0..k). smem: kStagingBytes of
// staging, 16-byte aligned; c_begin a multiple of kTileC.
__device__ __forceinline__ void scan_slab(const int8_t* __restrict__ queries,
                                          const int8_t* __restrict__ corpus,
                                          const int32_t* __restrict__ norms,
                                          const int32_t* __restrict__ banned, int M,
                                          int d, int nb, int k, int q0, int c_begin,
                                          int c_end, unsigned char* smem,
                                          key64* lists) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;    // the fragment's row group
  const int tig = lane & 3;   // thread in the group
  const int wm = warp >> 2;   // 2 warps along the queries, 64 rows each
  const int wn = warp & 3;    // 4 warps along the corpus, 32 rows each
  int* scores = reinterpret_cast<int*>(smem);

  for (int i = tid; i < kTileQ * k; i += kThreads) lists[i] = kEmptyKey;
  __syncthreads();

  const int nk = (d + kChunk - 1) / kChunk;
  for (int c0 = c_begin; c0 < c_end; c0 += kTileC) {
    int acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    load_stage(smem, queries, corpus, M, c_end, d, q0, c0, 0, tid);
    cp_async_commit();
#pragma unroll 1
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk) {
        load_stage(smem + ((kc + 1) % kStages) * kStageBytes, queries, corpus, M,
                   c_end, d, q0, c0, kc + 1, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const unsigned char* qs = smem + (kc % kStages) * kStageBytes;
      const unsigned char* cs = qs + kOperandBytes;
#pragma unroll
      for (int ks = 0; ks < kChunk / 32; ++ks) {
        const int kb = ks * 32 + tig * 4;
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const unsigned char* lo = qs + (wm * 64 + mi * 16 + g) * kRowBytes + kb;
          const unsigned char* hi = lo + 8 * kRowBytes;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(lo);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(hi);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(lo + 16);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(hi + 16);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const unsigned char* col = cs + (wn * 32 + ni * 8 + g) * kRowBytes + kb;
          b[ni][0] = *reinterpret_cast<const uint32_t*>(col);
          b[ni][1] = *reinterpret_cast<const uint32_t*>(col + 16);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
      }
      __syncthreads();  // the stage is free for the load after next
    }

    // the products of this tile, over the staging buffers
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int r = wm * 64 + mi * 16 + g;
        const int c = wn * 32 + ni * 8 + 2 * tig;
        *reinterpret_cast<int2*>(scores + r * kScoreStride + c) =
            make_int2(acc[mi][ni][0], acc[mi][ni][1]);
        *reinterpret_cast<int2*>(scores + (r + 8) * kScoreStride + c) =
            make_int2(acc[mi][ni][2], acc[mi][ni][3]);
      }
    }
    __syncthreads();

    // selection: this warp's 16 queries, this lane's 4 columns
    const int col0 = c0 + 4 * lane;
    int cn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) cn[j] = col0 + j < c_end ? norms[col0 + j] : kBig;
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int row = q0 + r;
      if (row >= M) break;
      const int4 dots = *reinterpret_cast<const int4*>(scores + r * kScoreStride + 4 * lane);
      const int dot[4] = {dots.x, dots.y, dots.z, dots.w};
      key64 key[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        key[j] = cn[j] >= kBig ? kNever : make_key(cn[j] - 2 * dot[j], col0 + j);
      }
      const int32_t* brow = banned + (size_t)row * nb;
      for (int b = 0; b < nb; ++b) {
        const int off = brow[b] - col0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (off == j) key[j] = kNever;
        }
      }
      key64* lst = lists + r * k;
      key64 kth = lst[k - 1];
      key64 best = key[0];
#pragma unroll
      for (int j = 1; j < 4; ++j) best = key[j] < best ? key[j] : best;
      if (!__any_sync(kFull, best < kth)) continue;
      // rare: some key of this row enters. Smallest first, one at a time
      while (true) {
        const key64 x = warp_min(best);
        if (!(x < kth)) break;
        best = kNever;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (key[j] == x) key[j] = kNever;
          best = key[j] < best ? key[j] : best;
        }
        warp_insert(lst, k, x, lane);
        kth = lst[k - 1];
      }
    }
    __syncthreads();  // the products are read: the next tile may load
  }
}

// out[row][0..k) from a sorted list of keys: distances with |q|^2 added.
__device__ __forceinline__ void write_result(const key64* lst, int k, int qnorm,
                                             int32_t* vals, int32_t* idx, int lane) {
  for (int t = lane; t < k; t += 32) {
    const key64 key = lst[t];
    vals[t] = (int)(key >> 32) + qnorm;
    idx[t] = (int)(key & 0xffffffffLL);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
topk_query_outer(const int8_t* __restrict__ queries, const int8_t* __restrict__ corpus,
                 const int32_t* __restrict__ norms, const int32_t* __restrict__ banned,
                 int32_t* __restrict__ vals, int32_t* __restrict__ idx, int M, int N,
                 int d, int nb, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  key64* lists = reinterpret_cast<key64*>(smem + kStagingBytes);
  const int q0 = blockIdx.x * kTileQ;
  scan_slab(queries, corpus, norms, banned, M, d, nb, k, q0, 0, N, smem, lists);
  // a warp's queries were its own in the scan: no block-wide wait is needed
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int row = q0 + r;
    if (row >= M) break;
    const int qnorm = warp_sq_norm(queries + (size_t)row * d, d, lane);
    write_result(lists + r * k, k, qnorm, vals + (size_t)row * k, idx + (size_t)row * k,
                 lane);
  }
}

// Block (query tile, slab): partial[slab][query][0..k) = the slab's sorted keys.
__global__ void __launch_bounds__(kThreads, 2)
topk_corpus_split(const int8_t* __restrict__ queries, const int8_t* __restrict__ corpus,
                  const int32_t* __restrict__ norms, const int32_t* __restrict__ banned,
                  key64* __restrict__ partial, int M, int N, int d, int nb, int k,
                  int slab_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  key64* lists = reinterpret_cast<key64*>(smem + kStagingBytes);
  const int q0 = blockIdx.x * kTileQ;
  const long long begin = (long long)blockIdx.y * slab_rows;
  const int c_begin = begin < N ? (int)begin : N;
  const int c_end = begin + slab_rows < N ? (int)(begin + slab_rows) : N;
  scan_slab(queries, corpus, norms, banned, M, d, nb, k, q0, c_begin, c_end, smem, lists);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int row = q0 + r;
    if (row >= M) break;
    key64* out = partial + ((size_t)blockIdx.y * M + row) * k;
    for (int t = lane; t < k; t += 32) out[t] = lists[r * k + t];
  }
}

// One warp a query: the slabs' sorted lists merged in key order. A key from
// a later slab with an equal distance has a higher index and a larger key,
// one from an earlier slab a smaller: the order is lexicographic whatever
// the order of arrival.
__global__ void __launch_bounds__(kMergeWarps * 32)
topk_merge(const key64* __restrict__ partial, const int8_t* __restrict__ queries,
           int32_t* __restrict__ vals, int32_t* __restrict__ idx, int M, int d, int k,
           int slabs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= M) return;
  key64* lst = reinterpret_cast<key64*>(smem) + warp * k;
  for (int t = lane; t < k; t += 32) lst[t] = partial[(size_t)row * k + t];
  __syncwarp();
  for (int s = 1; s < slabs; ++s) {
    const key64* part = partial + ((size_t)s * M + row) * k;
    for (int t = 0; t < k; ++t) {
      const key64 x = part[t];
      if (!(x < lst[k - 1])) break;  // the list is sorted: nothing later enters
      warp_insert(lst, k, x, lane);
    }
  }
  const int qnorm = warp_sq_norm(queries + (size_t)row * d, d, lane);
  write_result(lst, k, qnorm, vals + (size_t)row * k, idx + (size_t)row * k, lane);
}

cudaError_t check_args(int M, int N, int d, int nb, int k) {
  if (M < 0 || N < 1 || d < 16 || d % 16 != 0 || nb < 1 || k < 1 || k > kMaxK) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

int scan_smem_bytes(int k) { return kStagingBytes + kTileQ * k * (int)sizeof(key64); }

}  // namespace

extern "C" {

// Conventions of both entry points. queries (M, d) and corpus (N, d): int8,
// contiguous, 16-byte aligned, d a multiple of 16; norms (N,) int32, >= 2^30
// on padding rows; banned (M, nb) int32 corpus indices, -1 for none; vals and
// idx (M, k) int32; 1 <= k <= 128. Returns cudaGetLastError() after the
// launch.

int tr_topk_query_outer(const void* queries, const void* corpus, const void* norms,
                        const void* banned, void* vals, void* idx, int M, int N, int d,
                        int nb, int k, void* stream) {
  cudaError_t err = check_args(M, N, d, nb, k);
  if (err != cudaSuccess) return err;
  if (M == 0) return 0;
  const int bytes = scan_smem_bytes(k);
  err = cudaFuncSetAttribute(topk_query_outer, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  topk_query_outer<<<(M + kTileQ - 1) / kTileQ, kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(queries), static_cast<const int8_t*>(corpus),
      static_cast<const int32_t*>(norms), static_cast<const int32_t*>(banned),
      static_cast<int32_t*>(vals), static_cast<int32_t*>(idx), M, N, d, nb, k);
  return cudaGetLastError();
}

// partial: (slabs, M, k) int64 workspace. The corpus is cut into `slabs`
// runs of whole tiles; a slab past the corpus's end yields an empty list.
int tr_topk_corpus_split(const void* queries, const void* corpus, const void* norms,
                         const void* banned, void* partial, int slabs, void* vals,
                         void* idx, int M, int N, int d, int nb, int k, void* stream) {
  cudaError_t err = check_args(M, N, d, nb, k);
  if (err != cudaSuccess) return err;
  if (slabs < 1 || slabs > 65535) return cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (N + kTileC - 1) / kTileC;
  const int slab_rows = ((tiles + slabs - 1) / slabs) * kTileC;
  const int bytes = scan_smem_bytes(k);
  err = cudaFuncSetAttribute(topk_corpus_split,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kTileQ - 1) / kTileQ, slabs);
  topk_corpus_split<<<grid, kThreads, bytes, st>>>(
      static_cast<const int8_t*>(queries), static_cast<const int8_t*>(corpus),
      static_cast<const int32_t*>(norms), static_cast<const int32_t*>(banned),
      static_cast<key64*>(partial), M, N, d, nb, k, slab_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_merge<<<(M + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32,
               kMergeWarps * k * (int)sizeof(key64), st>>>(
      static_cast<const key64*>(partial), static_cast<const int8_t*>(queries),
      static_cast<int32_t*>(vals), static_cast<int32_t*>(idx), M, d, k, slabs);
  return cudaGetLastError();
}

const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
