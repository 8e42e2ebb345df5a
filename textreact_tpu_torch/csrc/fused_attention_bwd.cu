// Fused non-causal attention with in-kernel dropout, backward, for Hopper
// (sm_90a): the dQ pass and the dK/dV pass.
//
// Replaces: textreact_tpu/ops/fused_attention.py::_bwd_kernel (Pallas TPU).
// What it computes and its bound are set out at the head of
// fused_attention.cu, beside the forward whose statistics it reads.
//
// Design. Two passes, no atomics, so a call is deterministic:
// - dQ pass: one block per (tile of 64 queries, head, batch); writes
//   delta = rowsum(dO * O) on its way, streams over the keys and accumulates
//   dQ += dS k.
// - dK/dV pass: one block per (tile of 64 keys, head, batch); streams over
//   the queries with their m, l and delta, and accumulates
//   dV += (p * keep * inv_keep)^T dO and dK += dS^T q.
// with p = exp(s - m) / l and dS = p * (keep * inv_keep * (dO v^T) - delta)
// * scale. A masked key gives p = 0 exactly, as in the forward; in an
// all-masked row s - m is 0 for every key and p is uniform. The scores are
// recomputed in both passes (seven products for the five a one-pass design
// with atomics would need): that buys the determinism.
//
// Two paths, chosen by the element type alone (see fused_attention.cu):
// - bfloat16: the tensor-core kernels. All seven products are `mma.sync`
//   m16n8k16 of bf16 into f32. Per streamed tile of 64 (copied by `cp.async`
//   into two stages of padded bf16 shared memory) a warp owns 16 rows whose
//   operands stay in registers as A fragments, computes s and dP for 32
//   (dQ pass) or 16 (dK/dV pass) columns at a time, forms p and dS on the
//   accumulators and feeds them,
//   rounded to bf16 in registers as the TPU kernel rounds them, straight
//   into the next product. The dK/dV pass computes the TRANSPOSED tiles
//   k q^T and v dO^T for that reason: p^T and dS^T then have the layout of
//   an A fragment. Registers are the scarce resource (two 16 x 64 f32
//   gradient accumulators, two operand fragments, s and dP), hence the
//   pieces. In the transposed tile the four keys of one Philox draw lie
//   in four lanes, and the dQ pass has drawn every bit already (one draw for
//   four keys of a row, shared by the two lanes that hold them): it leaves
//   them, one bit an element, in a workspace of L^2 / 8 bytes a head, and
//   the dK/dV pass copies them in with its query tiles, so it makes no draw
//   at all and the backward draws each bit once (timed at B=32 L=512 H=12:
//   a dK/dV pass that draws its own bits takes 0.33 ms, one that reads the
//   12.6 MB of bits 0.20 ms, and writing them costs the dQ pass 0.014 ms).
//   Key tiles (dQ) and key blocks (dK/dV) with no valid key are left out
//   where that changes no bit.
// - float32: the exact kernels. TWO threads share a row, each holding every
//   other group of four head-dim elements of the row's operands and
//   accumulators, and a dot product over the head dim is two partial sums
//   joined by one warp shuffle; the streamed tile is read from f32 shared
//   memory as 16-byte broadcasts. The pair shares the work of drawing
//   dropout bits. The loop over the streamed tile is not unrolled beyond a
//   few steps: unrolled whole, the compiler hoists a tile's worth of
//   shared-memory loads into (spilled) registers.
//
// The kernels themselves are in attention_bwd.cuh, which
// causal_attention_bwd.cu shares.

#include "attention_bwd.cuh"

namespace {

template <typename T>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const int32_t* mask, const void* stats,
                Dropout drop, void* dq, void* dk, void* dv, void* delta,
                void* keep_words, int B, int L, int H, int D, float scale,
                cudaStream_t stream) {
  const bool dropout = drop.seed != nullptr;
#define TR_BWD(WV, DR)                                                         \
  return launch_bwd<T, WV, DR, false>(q, k, v, o, dout, mask, stats, drop, dq, dk, \
                                      dv, delta, keep_words, B, L, H, D, scale,   \
                                      stream);
  TR_DISPATCH(TR_BWD);
#undef TR_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Conventions of the entry point. dtype: 0 = float32, 1 = bfloat16.
// q, k, v, o, dout, dq, dk, dv: (B, L, H * D) contiguous, 16-byte aligned, D
// a multiple of 8 up to 128; mask: (B, L) int32 {0, 1} or null; stats: (B,
// H, L, 2) float32 (row max, normaliser) as the forward wrote them; delta:
// (B, H, L) float32 workspace; keep_words: (B, H, L / 64, L, 2) int32
// workspace, needed with bfloat16 and dropout, else null; seed: one int64 in
// device memory, or null for no dropout; threshold and inv_keep as in
// philox.cuh; head_offset and total_heads as the forward took them. Returns
// cudaGetLastError() after the launches.

int tr_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* mask,
                     const void* stats, const void* seed, uint32_t threshold,
                     float inv_keep, uint32_t head_offset, uint32_t total_heads,
                     void* dq, void* dk, void* dv, void* delta, void* keep_words,
                     int B, int L, int H, int D, float scale, void* stream) {
  const int32_t* m = static_cast<const int32_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total_heads == 0) total_heads = (uint32_t)H;
  if (head_offset + (uint32_t)H > total_heads) return cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, threshold, inv_keep, head_offset, total_heads);
  if (B == 0) return 0;
  if (dtype == 0) {
    return bwd<float>(q, k, v, o, dout, m, stats, drop, dq, dk, dv, delta, nullptr,
                      B, L, H, D, scale, st);
  }
  if (dtype == 1) {
    return bwd<__nv_bfloat16>(q, k, v, o, dout, m, stats, drop, dq, dk, dv, delta,
                              keep_words, B, L, H, D, scale, st);
  }
  return cudaErrorInvalidValue;
}

const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
