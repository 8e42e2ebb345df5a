// Fused non-causal attention with in-kernel dropout, backward, for Hopper
// (sm_90a): the dQ pass and the dK/dV pass.
//
// Replaces: textreact_tpu/ops/fused_attention.py::_bwd_kernel (Pallas TPU).
// What it computes and its bound are set out at the head of
// fused_attention.cu, beside the forward whose statistics it reads.
//
// Design. Two passes, no atomics, so a call is deterministic:
// - dQ pass: one block per (tile of 64 queries, head, batch); writes
//   delta = rowsum(dO * O) on its way, streams over keys in tiles of 32
//   staged in shared memory and accumulates dQ += dS k.
// - dK/dV pass: one block per (tile of 64 keys, head, batch); streams over
//   queries in tiles of 32 with their m, l and delta, and accumulates
//   dV += (p * keep * inv_keep)^T dO and dK += dS^T q.
// with p = exp(s - m) / l and dS = p * (keep * inv_keep * (dO v^T) - delta)
// * scale. A masked key gives p = 0 exactly, as in the forward; in an
// all-masked row s - m is 0 for every key and p is uniform.
//
// Registers are the scarce resource: a thread that held a 64-wide
// accumulator beside two 64-wide operand rows would need more than the 255
// a thread can have. So TWO threads share a row, each holding every other
// group of four head-dim elements of the row's operands and accumulators
// (96 or 128 registers), and a dot product over the head dim is two partial
// sums joined by one warp shuffle. The streamed tile is read from shared
// memory as 16-byte broadcasts; the pair's two addresses are 16 bytes apart,
// so they fall into different banks. The loop over the streamed tile is not
// unrolled beyond a few steps: unrolled whole, the compiler hoists a tile's
// worth of shared-memory loads into (spilled) registers.
//
// The kernels themselves are attention_bwd.cuh, which
// causal_attention_bwd.cu shares.
//
// The pair also shares the work of drawing dropout bits: each thread runs
// Philox for half of the elements the pair needs and the two exchange words
// by shuffle.

#include "attention_bwd.cuh"

namespace {

template <typename T>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const int32_t* mask, const void* stats,
                Dropout drop, void* dq, void* dk, void* dv, void* delta, int B,
                int L, int H, int D, float scale, cudaStream_t stream) {
  if (L % kRows != 0) return cudaErrorInvalidValue;
  const bool dropout = drop.seed != nullptr;
#define TR_BWD(DV, DR)                                                         \
  return launch_bwd<T, DV, DR, false>(q, k, v, o, dout, mask, stats, drop, dq, dk, \
                                      dv, delta, B, L, H, scale, stream);
  TR_DISPATCH(TR_BWD);
#undef TR_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Conventions of the entry point. dtype: 0 = float32, 1 = bfloat16.
// q, k, v, o, dout, dq, dk, dv: (B, L, H * D) contiguous, 16-byte aligned;
// mask: (B, L) int32 {0, 1} or null; stats: (B, H, L, 2) float32 (row max,
// normaliser) as the forward wrote them; delta: (B, H, L) float32 workspace;
// seed: one int64 in device memory, or null for no dropout; threshold and
// inv_keep as in philox.cuh. Returns cudaGetLastError() after the launches.

int tr_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* mask,
                     const void* stats, const void* seed, uint32_t threshold,
                     float inv_keep, void* dq, void* dk, void* dv, void* delta,
                     int B, int L, int H, int D, float scale, void* stream) {
  const int32_t* m = static_cast<const int32_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop = make_dropout(seed, threshold, inv_keep);
  if (B == 0) return 0;
  if (dtype == 0) {
    return bwd<float>(q, k, v, o, dout, m, stats, drop, dq, dk, dv, delta, B, L, H, D,
                      scale, st);
  }
  if (dtype == 1) {
    return bwd<__nv_bfloat16>(q, k, v, o, dout, m, stats, drop, dq, dk, dv, delta, B,
                              L, H, D, scale, st);
  }
  return cudaErrorInvalidValue;
}

const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
