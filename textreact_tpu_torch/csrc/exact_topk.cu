// Exact top-k nearest neighbours in squared L2 distance over int8 vectors,
// fused with the selection, for Hopper (sm_90a).
//
// Replaces: textreact_tpu/ops/topk.py::exact_topk_l2 (Pallas TPU), both of
// its layouts: `tr_topk_query_outer` stands for _topk_kernel (:95, the
// query-outer grid) and `tr_topk_corpus_split` (`topk_scan` over slabs, then
// `topk_merge`) for _topk_kernel_corpus_resident (:120). Per query the
// function is the k smallest of
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
// Bound: operations. 2 * M * N * d integer operations at the tensor cores'
// 1979 TOP/s int8 rate, against (N + M) * d bytes read once: at M = 8192
// that is thousands of operations a byte, far above the card's balance
// point.
//
// Design (k <= 128; past it see "Large k" below). `topk_scan` is a
// persistent kernel: one block of 288 threads an SM walks work items (query
// tile of 128, corpus slab). Warp 8 is the producer: its first lane streams
// both operands through a ring of 2-4 stages with the Tensor Memory
// Accelerator (cp.async.bulk.tensor, 128 rows x 128 bytes of d of the
// queries and of the corpus a stage, in the 128-byte swizzle that wgmma
// reads; rows past the matrix and bytes past d arrive as zeros) and signals
// each stage on an mbarrier. Warps 0-7 are two
// consumer warpgroups of 64 queries each. A warpgroup takes a corpus tile of
// 128 rows as four wgmma.m64n128k32 s8 x s8 -> s32 a stage, both operands
// read from shared memory (queries and corpus are row-major with d
// contiguous: K-major, as 8-bit wgmma needs), and frees each stage on
// another mbarrier as soon as its products are done. The selection then
// runs on the accumulators in registers: a thread holds two rows of 32
// columns, forms score = |c|^2 - 2 dot for each and tests the row's least
// score against the row's current k-th score as a 32-bit integer. Inside a
// slab the columns arrive in ascending index, so a later column with a
// distance equal to the k-th cannot enter and strict `<` is the whole test.
// After the first tiles almost nothing passes. What passes takes the rare
// path: padding rows, columns past the slab's end and banned ids are
// checked there, the 64-bit keys are formed, and the quad of lanes that
// holds a row inserts its candidates smallest first into the row's sorted
// list in shared memory. A row's list belongs to one quad of one warp, so no
// barrier is needed between warps: the two warpgroups are coupled only
// through the ring, and the selection of one overlaps the products of the
// other. (A second set of accumulators, to run a tile's products during the
// previous tile's selection in the same warpgroup, does not fit: the
// block's ninth warp caps a thread at 168 registers, and with a producer
// warpgroup and setmaxnreg ptxas still spilled 1.8 KB; either way the scan
// ran twice as long.)
//
// The TPU's corpus-resident kernel keeps every query's running list in VMEM
// while each corpus tile is read once. The card has no such memory for
// thousands of queries, so `tr_topk_corpus_split` cuts the corpus into S
// contiguous slabs of whole tiles: work item (query tile, slab) writes its
// sorted partial list of keys into an (S, M, k) workspace, and `topk_merge`
// (one warp a query) merges the S lists in key order. Items are numbered
// slab-major, so the blocks that run together read the same slab, which then
// comes from L2. `tr_topk_query_outer` is the same scan over one slab, its
// lists written as the result.
//
// Large k (128 < k <= 1024): `topk_scan<true>`. 128 sorted lists of k keys
// take 8 k bytes a query, 128 KB at k = 128, beside a ring of 3 stages: the
// block's shared memory ends there. And a list that has seen n columns still
// takes a new one with a probability of about k / n, so at k = 256 a query
// meets thousands of insertions, each a shift of ~k / 2 keys if one lane
// makes it. So past 128 a work item is 64 queries, ONE consumer warpgroup
// (its stage 24 KB: 64 query rows and 128 corpus rows), and the lists stay
// in shared memory up to the largest k whose 64 lists fit beside a ring of
// two stages (339; three stages at k = 256); past it they move to a
// workspace in device memory that the caller allocates, one slice of 64
// lists a block (the grid is at most one block an SM), beside four stages.
// The rare path then merges instead of inserting: each quad gathers its
// row's passing candidates of the tile, smallest first, into a run of up to
// 32 keys (a candidate j of the run must beat the list's (k - 1 - j)-th key,
// exactly the test a one-at-a-time insertion makes against its moving k-th
// key, so the same candidates enter), and the warp merges each row's run
// into its list in one pass (merge_run): each run key's slot is found by a
// binary search of the list, and each lane moves one slot a chunk of 32, top
// chunk first, so a tile's c candidates cost O(log k + (k - first slot) / 32)
// steps, not c shifts of up to k keys by one lane. Keys are unique (the index
// is in the low bits), so order, ties and banned ids are those of the
// insertion. topk_merge merges the slabs' lists by the same runs, a warp's
// one list in shared memory (8 KB at k = 1024).
//
// The plan for each k (queries a work item, stages, shared bytes, where the
// lists are) is scan_plan below; tr_topk_scan_plan reports it and
// ops/topk.py::scan_layout states it again in Python.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long key64;

constexpr int kWgRows = 64;          // queries a consumer warpgroup
constexpr int kTileC = 128;          // corpus rows a tile (wgmma N)
constexpr int kChunk = 128;          // bytes of d a stage (the swizzle width)
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;   // dynamic shared memory a block may use
constexpr int kAlign = 1024;         // the 128-byte swizzle's atom
constexpr int kMaxInsertK = 128;     // up to here two warpgroups insert one key at a time
constexpr int kMaxK = 1024;          // above, one warpgroup merges runs
constexpr int kRun = 32;             // keys of a run merged at once, one a lane
constexpr int kBig = 1 << 30;
constexpr int kMergeWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

// The two scans: kLarge (k > kMaxInsertK) takes one consumer warpgroup of 64
// queries and merges runs; else two warpgroups of 64 and the insertion.
template <bool kLarge>
struct Scan {
  static constexpr int kWarpgroups = kLarge ? 1 : 2;
  static constexpr int kTileQ = kWgRows * kWarpgroups;  // queries a work item
  static constexpr int kConsumerWarps = 4 * kWarpgroups;
  static constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
  static constexpr int kQueryBytes = kTileQ * kChunk;       // a stage: queries,
  static constexpr int kStageBytes = kQueryBytes + kTileC * kChunk;  // then corpus
  // a run of kRun keys for each of a warp's 8 quads
  static constexpr int kRunBytes = kLarge ? kConsumerWarps * 8 * kRun * 8 : 0;
};

__device__ __forceinline__ key64 make_key(int score, int index) {
  return (key64)(((unsigned long long)(unsigned)score << 32) | (unsigned)index);
}
constexpr key64 kEmptyKey = ((key64)kBig << 32) | (key64)kBig;  // an unfilled slot
constexpr key64 kNever = 0x7fffffffffffffffLL;                  // passes no test

// ---- mbarriers and the Tensor Memory Accelerator -------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// box (rows [row, row + 128), bytes [col, col + 128)) of `map` into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major tile under the 128-byte
// swizzle: rows of 128 bytes, groups of 8 rows 1024 bytes apart (stride
// byte offset), the leading byte offset unused for this layout; the tile
// starts 1024-byte aligned, so the base offset is 0. A step of 32 bytes
// along K adds 2 to the address field.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3ffffULL) >> 4) | (1ULL << 16) | (64ULL << 32) | (1ULL << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// d (64 x 128, s32, the warpgroup's accumulator fragments) = a (64 x 32 s8)
// * b (128 x 32 s8)^T + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// keeps the compiler from moving reads of the accumulators above the wait
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---- lists ------------------------------------------------------------------

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The whole warp merges the ascending run r[0..c) (c <= 32) into the
// ascending list lst[0..k) of distinct keys, keeping the k smallest: the
// caller has checked that r[j] < lst[k - 1 - j] for each j, so every run key
// lands inside the list. Lane j finds r[j]'s slot p_j = j + (keys of lst
// below r[j]) by a binary search; then, one chunk of 32 slots at a time from
// the top chunk down to the one that holds p_0, lane l fills slot o = o0 + l
// from the run (o is some p_j) or from lst[o - (run keys before o)], all of
// a chunk's reads before any of its writes. A chunk reads no slot above its
// own, and the chunks below it are still as they were.
__device__ __forceinline__ void merge_run(key64* lst, int k, const key64* r, int c,
                                          int lane) {
  int p = k;  // lanes past the run: past the list
  if (lane < c) {
    const key64 x = r[lane];
    int lo = 0, hi = k - 1 - lane;  // lst[hi] > x
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (lst[mid] < x) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    p = lane + lo;
  }
  const int first = __shfl_sync(kFull, p, 0);
  for (int o0 = ((k - 1) / 32) * 32; o0 >= 0 && o0 + 31 >= first; o0 -= 32) {
    const int o = o0 + lane;
    const uint32_t mine = (lane < c && p >= o0 && p < o0 + 32) ? 1u << (p - o0) : 0u;
    const uint32_t slots = __reduce_or_sync(kFull, mine);  // run keys in the chunk
    const int before = __popc(__ballot_sync(kFull, p < o0)) +
                       __popc(slots & ((1u << lane) - 1u));  // run keys before o
    const bool moves = o < k && o >= first;
    key64 v = 0;
    if (moves) v = ((slots >> lane) & 1u) ? r[before] : lst[o - before];
    __syncwarp();
    if (moves) lst[o] = v;
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

// out[row][0..k) from a sorted list of keys: distances with |q|^2 added.
__device__ __forceinline__ void write_result(const key64* lst, int k, int qnorm,
                                             int32_t* vals, int32_t* idx, int lane) {
  for (int t = lane; t < k; t += 32) {
    const key64 key = lst[t];
    vals[t] = (int)(key >> 32) + qnorm;
    idx[t] = (int)(key & 0xffffffffLL);
  }
}

__device__ __forceinline__ int score_of(int cn, int dot) {
  // wraps, never traps, for norms near 2^31 (padding): the rare path rejects
  return (int)((unsigned)cn - 2u * (unsigned)dot);
}

// The rare path of one of the thread's two rows (kHalf 0: row g, 1: row
// g + 8 of its warp's 16), by the whole warp. acc[4 j + 2 kHalf + e] is the
// product with column c0 + 8 j + 2 tig + e, cn[2 j + e] that column's norm
// (kBig past the slab's end). Each quad walks its row's candidates smallest
// first; the first that does not beat the k-th key ends the row.
template <int kHalf>
__device__ __forceinline__ void rare_row(const int (&acc)[64], const int (&cn)[32],
                                         key64& kth, key64* lst, int k, int c0,
                                         bool row_valid,
                                         const int32_t* __restrict__ brow, int nb,
                                         int tig) {
  const int kth_score = (int)(kth >> 32);
  uint32_t pend = 0;
  if (row_valid) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = score_of(cn[2 * j + e], acc[4 * j + 2 * kHalf + e]);
        if (s < kth_score && cn[2 * j + e] < kBig) pend |= 1u << (2 * j + e);
      }
    }
  }
  while (__any_sync(kFull, pend != 0u)) {
    key64 mine = kNever;
    int me = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if ((pend >> (2 * j + e)) & 1u) {
          const key64 key = make_key(score_of(cn[2 * j + e], acc[4 * j + 2 * kHalf + e]),
                                     c0 + 8 * j + 2 * tig + e);
          if (key < mine) {
            mine = key;
            me = 2 * j + e;
          }
        }
      }
    }
    key64 qmin = mine;
    key64 o = __shfl_xor_sync(kFull, qmin, 1);
    qmin = o < qmin ? o : qmin;
    o = __shfl_xor_sync(kFull, qmin, 2);
    qmin = o < qmin ? o : qmin;
    if (qmin != kNever) {
      if (!(qmin < kth)) {
        pend = 0u;  // sorted: nothing later in this row enters
      } else {
        if (pend != 0u && mine == qmin) pend &= ~(1u << me);
        const int col = (int)(qmin & 0xffffffffLL);
        bool banned = false;
        for (int b = 0; b < nb; ++b) banned |= brow[b] == col;
        if (!banned && tig == 0) {
          int t = k - 1;
          while (t > 0 && lst[t - 1] > qmin) {
            lst[t] = lst[t - 1];
            --t;
          }
          lst[t] = qmin;
        }
      }
    }
    __syncwarp();
    kth = lst[k - 1];
  }
}

// The rare path of the large-k scan for one of the thread's two rows (kHalf
// as in rare_row), by the whole warp. `warp_lists`: the warp's 16 lists of
// k keys; `runs`: the warp's 8 runs of kRun keys, one a quad. A round: each
// quad gathers its row's candidates smallest first into its run, a
// candidate j taken only if it beats lst[k - 1 - j] (the first that does not
// ends the row: nothing later in it enters), a banned one skipped, until the
// run holds kRun keys; then the warp merges each quad's run into its list
// (merge_run). Rows with more than kRun candidates take more rounds, each
// against the merged list.
template <int kHalf>
__device__ __forceinline__ void rare_row_merge(const int (&acc)[64], const int (&cn)[32],
                                               key64& kth, key64* warp_lists,
                                               key64* runs, int k, int c0,
                                               bool row_valid,
                                               const int32_t* __restrict__ brow, int nb,
                                               int lane) {
  const int g = lane >> 2, tig = lane & 3;
  key64* lst = warp_lists + (g + 8 * kHalf) * k;
  key64* run = runs + g * kRun;
  const int kth_score = (int)(kth >> 32);
  uint32_t pend = 0;
  if (row_valid) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = score_of(cn[2 * j + e], acc[4 * j + 2 * kHalf + e]);
        if (s < kth_score && cn[2 * j + e] < kBig) pend |= 1u << (2 * j + e);
      }
    }
  }
  while (__any_sync(kFull, pend != 0u)) {
    // the quad gathers while one of its lanes holds a candidate
    bool gathering = ((__ballot_sync(kFull, pend != 0u) >> (lane & ~3)) & 0xfu) != 0u;
    int n = 0;  // keys in the run, the same in the quad's four lanes
    while (__any_sync(kFull, gathering)) {
      key64 mine = kNever;
      int me = 0;
      if (gathering) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if ((pend >> (2 * j + e)) & 1u) {
              const key64 key = make_key(score_of(cn[2 * j + e], acc[4 * j + 2 * kHalf + e]),
                                         c0 + 8 * j + 2 * tig + e);
              if (key < mine) {
                mine = key;
                me = 2 * j + e;
              }
            }
          }
        }
      }
      key64 qmin = mine;
      key64 o = __shfl_xor_sync(kFull, qmin, 1);
      qmin = o < qmin ? o : qmin;
      o = __shfl_xor_sync(kFull, qmin, 2);
      qmin = o < qmin ? o : qmin;
      if (gathering) {
        if (qmin == kNever || !(qmin < lst[k - 1 - n])) {
          pend = 0u;  // sorted: nothing later in this row enters
          gathering = false;
        } else {
          if (mine == qmin) pend &= ~(1u << me);
          const int col = (int)(qmin & 0xffffffffLL);
          bool banned = false;
          for (int b = 0; b < nb; ++b) banned |= brow[b] == col;
          if (!banned) {
            if (tig == 0) run[n] = qmin;
            if (++n == kRun) gathering = false;
          }
        }
      }
    }
    __syncwarp();
    // the warp merges the runs one row at a time
    uint32_t todo = __ballot_sync(kFull, tig == 0 && n > 0);
    while (todo != 0u) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int q = src >> 2;
      merge_run(warp_lists + (q + 8 * kHalf) * k, k, runs + q * kRun,
                __shfl_sync(kFull, n, src), lane);
    }
    __syncwarp();
    kth = lst[k - 1];
  }
}

// One block an SM walks the work items (query tile of Scan<kLarge>::kTileQ,
// slab); see the head of the file. `partial` null: one slab, and its lists
// are the result (vals, idx with |q|^2); else partial[slab][query][0..k) =
// the slab's keys. smem: the ring (stages x kStageBytes, 1024-aligned), full
// and empty barriers, with kLarge the warps' runs, then kTileQ sorted lists
// of k keys, or, where `glists` is not null, the block's kTileQ lists at
// glists + blockIdx * kTileQ * k in device memory.
template <bool kLarge>
__global__ void __launch_bounds__(Scan<kLarge>::kThreads, 1)
topk_scan(const __grid_constant__ CUtensorMap qmap,
          const __grid_constant__ CUtensorMap cmap, const int8_t* __restrict__ queries,
          const int32_t* __restrict__ norms, const int32_t* __restrict__ banned,
          key64* __restrict__ partial, int32_t* __restrict__ vals,
          int32_t* __restrict__ idx, key64* glists, int M, int N, int d, int nb, int k,
          int slabs, int slab_rows, int stages) {
  using S = Scan<kLarge>;
  constexpr int kTileQ = S::kTileQ;
  constexpr int kConsumerWarps = S::kConsumerWarps;
  constexpr int kStageBytes = S::kStageBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~(uintptr_t)(kAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kStageBytes);
  uint64_t* empty = full + kMaxStages;
  unsigned char* after = reinterpret_cast<unsigned char*>(empty + kMaxStages);
  key64* all_runs = reinterpret_cast<key64*>(after);  // kLarge only
  key64* lists = glists != nullptr ? glists + (size_t)blockIdx.x * kTileQ * k
                                    : reinterpret_cast<key64*>(after + S::kRunBytes);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int q_tiles = (M + kTileQ - 1) / kTileQ;
  const int n_items = q_tiles * slabs;
  const int nk = (d + kChunk - 1) / kChunk;

  if (warp == kConsumerWarps) {
    // ---- producer: one lane keeps the ring full --------------------------
    if (lane != 0) return;
    int s = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int q0 = (item % q_tiles) * kTileQ;
      const long long begin = (long long)(item / q_tiles) * slab_rows;
      const int c_begin = begin < N ? (int)begin : N;
      const int c_end = begin + slab_rows < N ? (int)(begin + slab_rows) : N;
      for (int c0 = c_begin; c0 < c_end; c0 += kTileC) {
        for (int kc = 0; kc < nk; ++kc) {
          bar_wait(&empty[s], phase ^ 1u);
          bar_expect(&full[s], kStageBytes);
          unsigned char* stage = ring + s * kStageBytes;
          tma_load(stage, &qmap, &full[s], kc * kChunk, q0);
          tma_load(stage + S::kQueryBytes, &cmap, &full[s], kc * kChunk, c0);
          if (++s == stages) {
            s = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup of 64 queries, or two ----------------------
  const int wg = warp >> 2;
  const int g = lane >> 2;    // the fragment's row group
  const int tig = lane & 3;   // thread in the group
  const int r0 = wg * kWgRows + 16 * (warp & 3) + g;  // rows r0, r0 + 8 of the tile
  key64* lst0 = lists + r0 * k;
  key64* lst1 = lists + (r0 + 8) * k;
  key64* warp_lists = lists + (wg * kWgRows + 16 * (warp & 3)) * k;
  key64* runs = all_runs + warp * 8 * kRun;  // kLarge: the warp's 8 runs

  for (int t = lane; t < 16 * k; t += 32) warp_lists[t] = kEmptyKey;
  __syncwarp();
  key64 kth0 = kEmptyKey, kth1 = kEmptyKey;

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  int s = 0;
  uint32_t phase = 0;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int slab = item / q_tiles;
    const int q0 = (item % q_tiles) * kTileQ;
    const long long begin = (long long)slab * slab_rows;
    const int c_begin = begin < N ? (int)begin : N;
    const int c_end = begin + slab_rows < N ? (int)(begin + slab_rows) : N;
    const bool valid0 = q0 + r0 < M, valid1 = q0 + r0 + 8 < M;
    const int32_t* brow0 = banned + (size_t)(valid0 ? q0 + r0 : 0) * nb;
    const int32_t* brow1 = banned + (size_t)(valid1 ? q0 + r0 + 8 : 0) * nb;

#pragma unroll 1
    for (int c0 = c_begin; c0 < c_end; c0 += kTileC) {
      // this thread's 32 columns' norms, loaded while the products run
      int cn[32];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = c0 + 8 * j + 2 * tig;
        if (col + 1 < c_end) {
          const int2 v = __ldg(reinterpret_cast<const int2*>(norms + col));
          cn[2 * j] = v.x;
          cn[2 * j + 1] = v.y;
        } else {
          cn[2 * j] = col < c_end ? __ldg(norms + col) : kBig;
          cn[2 * j + 1] = kBig;
        }
      }

      int prev = 0;
#pragma unroll 1
      for (int kc = 0; kc < nk; ++kc) {
        bar_wait(&full[s], phase);
        const unsigned char* stage = ring + s * kStageBytes;
        const uint64_t da = sw128_desc(stage + wg * kWgRows * kChunk);
        const uint64_t db = sw128_desc(stage + S::kQueryBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunk / 32; ++kk) {
          wgmma_s8_n128(acc, da + 2 * kk, db + 2 * kk, (kc | kk) != 0);
        }
        wgmma_commit();
        if (kc > 0) {
          wgmma_wait<1>();  // the previous stage's products are done
          if (lane == 0) bar_arrive(&empty[prev]);
        }
        prev = s;
        if (++s == stages) {
          s = 0;
          phase ^= 1u;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) bar_arrive(&empty[prev]);
      fence_operands(acc);

      // hot path: each row's least score against its k-th score
      int m0 = 0x7fffffff, m1 = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          m0 = min(m0, score_of(cn[2 * j + e], acc[4 * j + e]));
          m1 = min(m1, score_of(cn[2 * j + e], acc[4 * j + 2 + e]));
        }
      }
      const bool hit0 = m0 < (int)(kth0 >> 32), hit1 = m1 < (int)(kth1 >> 32);
      if constexpr (kLarge) {
        if (__any_sync(kFull, hit0)) {
          rare_row_merge<0>(acc, cn, kth0, warp_lists, runs, k, c0, valid0, brow0, nb,
                            lane);
        }
        if (__any_sync(kFull, hit1)) {
          rare_row_merge<1>(acc, cn, kth1, warp_lists, runs, k, c0, valid1, brow1, nb,
                            lane);
        }
      } else {
        if (__any_sync(kFull, hit0)) {
          rare_row<0>(acc, cn, kth0, lst0, k, c0, valid0, brow0, nb, tig);
        }
        if (__any_sync(kFull, hit1)) {
          rare_row<1>(acc, cn, kth1, lst1, k, c0, valid1, brow1, nb, tig);
        }
      }
    }

    // the item's lists out, then empty for the next item (the warp's own)
    __syncwarp();
    for (int i = 0; i < 16; ++i) {
      const int row = q0 + wg * kWgRows + 16 * (warp & 3) + i;
      if (row >= M) break;
      const key64* lst = warp_lists + i * k;
      if (partial != nullptr) {
        key64* out = partial + ((size_t)slab * M + row) * k;
        for (int t = lane; t < k; t += 32) out[t] = lst[t];
      } else {
        const int qnorm = warp_sq_norm(queries + (size_t)row * d, d, lane);
        write_result(lst, k, qnorm, vals + (size_t)row * k, idx + (size_t)row * k,
                     lane);
      }
    }
    __syncwarp();
    for (int t = lane; t < 16 * k; t += 32) warp_lists[t] = kEmptyKey;
    __syncwarp();
    kth0 = kth1 = kEmptyKey;
  }
}

// One warp a query: the slabs' sorted lists merged in key order. A key from
// a later slab with an equal distance has a higher index and a larger key,
// one from an earlier slab a smaller: the order is lexicographic whatever
// the order of arrival. A slab's list goes in by runs of 32 (merge_run): the
// run is the longest prefix of its next 32 keys whose key j beats the
// list's (k - 1 - j)-th, and a run shorter than 32 ends the slab.
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
    for (int t0 = 0; t0 < k; t0 += kRun) {
      const bool pass = t0 + lane < k && part[t0 + lane] < lst[k - 1 - lane];
      const uint32_t ok = __ballot_sync(kFull, pass);  // a prefix of the lanes
      const int c = ok == kFull ? kRun : __ffs(~ok) - 1;
      if (c > 0) merge_run(lst, k, part + t0, c, lane);
      if (c < kRun) break;  // both lists are sorted: nothing later enters
    }
  }
  const int qnorm = warp_sq_norm(queries + (size_t)row * d, d, lane);
  write_result(lst, k, qnorm, vals + (size_t)row * k, idx + (size_t)row * k, lane);
}

// ---- host side --------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the CUDA runtime, so that
// the library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                       12000, cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// (rows, d) int8 row-major as boxes of 128 rows x 128 bytes, 128-byte
// swizzle; reads past either edge give zeros
cudaError_t make_map(CUtensorMap* map, const void* base, int rows, int d,
                     int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d};
  const cuuint32_t box[2] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                            const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t check_args(int M, int N, int d, int nb, int k) {
  if (M < 0 || N < 1 || d < 16 || d % 16 != 0 || nb < 1 || k < 1 || k > kMaxK) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// The scan's plan for k: queries a work item, stages of the ring, whether
// the lists are in the caller's device memory, and the dynamic shared memory
// a block takes (the ring, its barriers, the runs, the lists where they fit
// beside two stages). ops/topk.py::scan_layout states it again.
struct ScanPlan {
  int tile_q, stages, device_lists, bytes;
};

template <bool kLarge>
ScanPlan plan_for(int k) {
  using S = Scan<kLarge>;
  const int fixed = kAlign + 2 * kMaxStages * 8 + S::kRunBytes;
  const int lists = S::kTileQ * k * (int)sizeof(key64);
  ScanPlan p;
  p.tile_q = S::kTileQ;
  p.device_lists = fixed + 2 * S::kStageBytes + lists > kSmemLimit;
  const int held = fixed + (p.device_lists ? 0 : lists);
  const int s = (kSmemLimit - held) / S::kStageBytes;
  p.stages = s < kMaxStages ? s : kMaxStages;
  p.bytes = held + p.stages * S::kStageBytes;
  return p;
}

ScanPlan scan_plan(int k) {
  return k > kMaxInsertK ? plan_for<true>(k) : plan_for<false>(k);
}

// One launch of topk_scan over `slabs` slabs of `slab_rows` rows: a block
// an SM, never more blocks than work items.
template <bool kLarge>
cudaError_t launch_scan(const void* queries, const void* corpus, const void* norms,
                        const void* banned, void* partial, void* vals, void* idx,
                        void* lists, int M, int N, int d, int nb, int k, int slabs,
                        int slab_rows, cudaStream_t stream) {
  using S = Scan<kLarge>;
  const ScanPlan plan = plan_for<kLarge>(k);
  if ((plan.device_lists != 0) != (lists != nullptr) || plan.stages < 2) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap qmap, cmap;
  cudaError_t err = make_map(&qmap, queries, M, d, S::kTileQ);
  if (err != cudaSuccess) return err;
  err = make_map(&cmap, corpus, N, d, kTileC);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(topk_scan<kLarge>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, plan.bytes);
  if (err != cudaSuccess) return err;
  const int items = ((M + S::kTileQ - 1) / S::kTileQ) * slabs;
  const int grid = items < sms ? items : sms;
  topk_scan<kLarge><<<grid, S::kThreads, plan.bytes, stream>>>(
      qmap, cmap, static_cast<const int8_t*>(queries),
      static_cast<const int32_t*>(norms), static_cast<const int32_t*>(banned),
      static_cast<key64*>(partial), static_cast<int32_t*>(vals),
      static_cast<int32_t*>(idx), static_cast<key64*>(lists), M, N, d, nb, k, slabs,
      slab_rows, plan.stages);
  return cudaGetLastError();
}

cudaError_t launch_scan_for(const void* queries, const void* corpus, const void* norms,
                            const void* banned, void* partial, void* vals, void* idx,
                            void* lists, int M, int N, int d, int nb, int k, int slabs,
                            int slab_rows, cudaStream_t stream) {
  if (k > kMaxInsertK) {
    return launch_scan<true>(queries, corpus, norms, banned, partial, vals, idx, lists,
                             M, N, d, nb, k, slabs, slab_rows, stream);
  }
  return launch_scan<false>(queries, corpus, norms, banned, partial, vals, idx, lists, M,
                            N, d, nb, k, slabs, slab_rows, stream);
}

}  // namespace

extern "C" {

// Conventions of both entry points. queries (M, d) and corpus (N, d): int8,
// contiguous, 16-byte aligned, d a multiple of 16; norms (N,) int32, >= 2^30
// on padding rows; banned (M, nb) int32 corpus indices, -1 for none; vals and
// idx (M, k) int32; 1 <= k <= 1024; lists: null where the plan keeps them in
// shared memory, else an int64 workspace of (multiprocessors, queries a work
// item, k) keys (scan_plan). Returns cudaGetLastError() after the launch.

int tr_topk_query_outer(const void* queries, const void* corpus, const void* norms,
                        const void* banned, void* vals, void* idx, void* lists, int M,
                        int N, int d, int nb, int k, void* stream) {
  cudaError_t err = check_args(M, N, d, nb, k);
  if (err != cudaSuccess) return err;
  if (M == 0) return 0;
  const int slab_rows = ((N + kTileC - 1) / kTileC) * kTileC;
  return launch_scan_for(queries, corpus, norms, banned, nullptr, vals, idx, lists, M,
                         N, d, nb, k, 1, slab_rows, static_cast<cudaStream_t>(stream));
}

// partial: (slabs, M, k) int64 workspace. The corpus is cut into `slabs`
// runs of whole tiles; a slab past the corpus's end yields an empty list.
int tr_topk_corpus_split(const void* queries, const void* corpus, const void* norms,
                         const void* banned, void* partial, int slabs, void* vals,
                         void* idx, void* lists, int M, int N, int d, int nb, int k,
                         void* stream) {
  cudaError_t err = check_args(M, N, d, nb, k);
  if (err != cudaSuccess) return err;
  if (slabs < 1 || slabs > 65535) return cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (N + kTileC - 1) / kTileC;
  const int slab_rows = ((tiles + slabs - 1) / slabs) * kTileC;
  err = launch_scan_for(queries, corpus, norms, banned, partial, nullptr, nullptr, lists,
                        M, N, d, nb, k, slabs, slab_rows, st);
  if (err != cudaSuccess) return err;
  topk_merge<<<(M + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32,
               kMergeWarps * k * (int)sizeof(key64), st>>>(
      static_cast<const key64*>(partial), static_cast<const int8_t*>(queries),
      static_cast<int32_t*>(vals), static_cast<int32_t*>(idx), M, d, k, slabs);
  return cudaGetLastError();
}

// The scan's plan for k (1..1024): returns the bytes of dynamic shared
// memory a block takes and writes the queries of a work item, the stages of
// its ring and 1 where the lists are in device memory (else 0) to plan[0..3);
// -1 for a k the kernels do not take.
int tr_topk_scan_plan(int k, int* plan) {
  if (k < 1 || k > kMaxK) return -1;
  const ScanPlan p = scan_plan(k);
  plan[0] = p.tile_q;
  plan[1] = p.stages;
  plan[2] = p.device_lists;
  return p.bytes;
}

const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
