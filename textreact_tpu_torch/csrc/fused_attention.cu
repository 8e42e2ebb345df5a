// Fused non-causal attention with in-kernel dropout on the probabilities,
// forward and backward, for Hopper (sm_90a).
//
// Replaces: textreact_tpu/ops/fused_attention.py::_fwd_kernel and
// ::_bwd_kernel (Pallas TPU). Forward: out = dropout(softmax(q k^T * scale +
// mask_bias)) v per (batch, head), where a key with mask 0 gets the additive
// bias -1e9 (not -inf: a row whose keys are all masked, as in the collator's
// dummy rows, stays finite and averages v), and the softmax normaliser runs
// over the UNDROPPED weights (torch/HF semantics). Backward: dq, dk, dv from
// q, k, v, o, do with the dropout mask regenerated from the seed. q, k, v,
// out and the gradients stay in the model's (B, L, H * D) activation layout,
// as on the TPU, so no transpose runs around a call.
//
// What the TPU kernels lean on and this card does not have: a whole (L, L)
// f32 score tile per head in on-chip memory (512 x 512 x 4 B = 1 MB against
// 227 KB of shared memory per block), and a per-core PRNG stream whose order
// forward and backward share. So the scores are never materialised: the
// forward streams over the keys with an online softmax and writes the row
// statistics (max m, normaliser l) for the backward, which recomputes
// p = exp(s - m) / l tile by tile; and the dropout bits come from a
// counter-based generator indexed by (batch * H + head, query row, key
// column) (philox.cuh), so every kernel draws the same bit for the same
// element whatever its tiling.
//
// The statistics are the pair (m, l), not the log-sum-exp m + log l: in an
// all-masked row m is -1e9, where f32 numbers are 64 apart, so m + log l
// would round to m and the backward would recompute p = 1 instead of 1 / L.
//
// Bounds at the slice's shape (B=32, L=512, H=12, D=64, bf16): forward
// 4 * B * H * L^2 * D = 25.8 GFLOP (26 us at the bf16 tensor-core peak)
// against 4 * 25 MB moved (30 us); backward 10 * B * H * L^2 * D = 64 GFLOP
// (65 us) against 8 * 25 MB (60 us): close to the card's balance point. With
// dropout the generator's integer work joins them. A Philox4x32-10 draw
// serves four elements and needs at least 40 integer instructions: ten
// rounds of two 32 x 32 -> 64 bit products and two three-way xors (the round
// keys belong to the call's seed, not to the draw; as compiled here a draw
// takes more, some 70, with the halves of a product made apart).
// B * H * L^2 / 4 = 25 M draws a pass are 1.0 G instructions at the least,
// which the card's integer units (64 lanes an SM a clock, 16.75 T a second)
// take 60 us for: twice the forward's other bounds, level with the
// backward's.
//
// Two paths, chosen by the element type alone, never by a failed build or
// launch:
// - bfloat16, the type of the main path on the card (serving: bf16 weights;
//   training: bf16 compute): the tensor-core kernels. What binds an
//   attention kernel on this card is arithmetic outside the tensor cores: at
//   67 TFLOP/s of f32 FMA the two products alone take 0.39 ms forward and
//   1.35 ms backward, 15 to 20 times the bounds above. So every product is
//   an `mma.sync.aligned.m16n8k16` of bf16 into f32 accumulators (the same
//   roundings as the TPU kernel: inputs bf16, sums f32, the weights and dS
//   rounded to bf16 before their second product), and what is left on the
//   ordinary units is the softmax (one exp a score), the dropout bits and
//   the address arithmetic. Shared memory holds bf16 tiles only, filled by
//   16-byte `cp.async` into two stages so that loads run under products,
//   rows padded by 16 bytes so that `ldmatrix` meets no bank conflict; the
//   weights never leave registers between the two products, because the
//   accumulator layout of one m16n8k16 is the A layout of the next. One Philox
//   draw is made per four elements and its words are exchanged by shuffle
//   between the lanes that hold them. Key tiles with no valid key are not
//   visited where leaving them out changes no bit (attention_mma.cuh).
// - float32: the exact kernels, f32 FMA arithmetic through f32 shared-memory
//   tiles. They show the algorithm right to summation order (2e-5 against the
//   plain version), which TF32 products would not, and are what a float32
//   model runs. One thread per query row, keys in tiles of 32; they are
//   bound by the card's f32 FMA rate and are not the path that is timed.
// Either way outputs are in the input dtype and there are no atomics, so a
// call is deterministic. Both take any head dim D that is a multiple of 8 up
// to 128, at the instantiated width W = 32, 64 or 128 that holds it
// (TR_DISPATCH): the kernels read and write the D columns of a head in rows
// of H * D and hold columns D .. W - 1 of their tiles at zero, so no padded
// copy of any tensor is made and the result is, to the bit, that of the W
// kernel on inputs zero-padded to W. The TPU kernel takes any head dim, and a
// model whose heads are of another is refused on the card before its first
// batch (models/factory.py).
//
// - forward: the keep mask is applied to the unnormalised weight AFTER it is
//   added to l, and inv_keep / l scales the output once.
// - backward: a dQ pass and a dK/dV pass that recompute p = exp(s - m) / l
//   tile by tile, with dS = p * (keep * inv_keep * (dO v^T) - delta) * scale
//   and delta = rowsum(dO * O); set out in fused_attention_bwd.cu.
//
// This file holds the forward's entry point and the test-only mask export;
// the kernels themselves are in attention_fwd.cuh, which causal_attention.cu
// shares, on the building blocks of attention_mma.cuh; the backward is
// fused_attention_bwd.cu.

#include "attention_fwd.cuh"

namespace {

// Test-only: the keep mask of (seed, B * H, L, L), one byte per element,
// for heads head_offset .. + H of total_heads (the Dropout's fields).
__global__ void attention_keep_mask(Dropout drop, uint8_t* __restrict__ out,
                                    int64_t B, int H, int L) {
  const int L4 = L / 4;
  const int64_t n = B * H * L * L4;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t col4 = (uint32_t)(i % L4);
  const uint32_t row = (uint32_t)((i / L4) % L);
  const int64_t bh = i / ((int64_t)L4 * L);
  const uint32_t threshold = drop.threshold;
  uint32_t bits[4];
  tr::attention_bits((uint64_t)*drop.seed,
                     tr::dropout_head(drop, (int)(bh / H), (int)(bh % H)), row,
                     col4, bits);
  uchar4 keep;
  keep.x = bits[0] >= threshold;
  keep.y = bits[1] >= threshold;
  keep.z = bits[2] >= threshold;
  keep.w = bits[3] >= threshold;
  reinterpret_cast<uchar4*>(out)[i] = keep;
}

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, const int32_t* mask,
                void* out, void* stats, Dropout drop, int B, int L, int H, int D,
                float scale, cudaStream_t stream) {
  const bool dropout = drop.seed != nullptr;
#define TR_FWD(WV, DR)                                                         \
  return launch_fwd<T, WV, DR, false>(q, k, v, mask, out, stats, drop, B, L, H, \
                                      D, scale, stream);
  TR_DISPATCH(TR_FWD);
#undef TR_FWD
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Conventions of every entry point. dtype: 0 = float32, 1 = bfloat16.
// q, k, v, out, o, dout, dq, dk, dv: (B, L, H * D) contiguous, D a multiple
// of 8 up to 128; mask: (B, L) int32 {0, 1} or null; stats: (B, H, L, 2)
// float32 (row max, normaliser); delta: (B, H, L) float32 workspace; seed:
// one int64 in device memory, or null for no dropout; threshold and inv_keep
// as in philox.cuh; the H heads are heads head_offset .. + H of a layer of
// total_heads (0: H) and draw that layer's masks. Returns cudaGetLastError()
// after the launch.

int tr_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                     const void* mask, void* out, void* stats, const void* seed,
                     uint32_t threshold, float inv_keep, uint32_t head_offset,
                     uint32_t total_heads, int B, int L, int H, int D, float scale,
                     void* stream) {
  const int32_t* m = static_cast<const int32_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total_heads == 0) total_heads = (uint32_t)H;
  if (head_offset + (uint32_t)H > total_heads) return cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, threshold, inv_keep, head_offset, total_heads);
  if (B == 0) return 0;
  if (dtype == 0) return fwd<float>(q, k, v, m, out, stats, drop, B, L, H, D, scale, st);
  if (dtype == 1) {
    return fwd<__nv_bfloat16>(q, k, v, m, out, stats, drop, B, L, H, D, scale, st);
  }
  return cudaErrorInvalidValue;
}

// Test-only: out (B, H, L, L) uint8, 1 where the element is kept, for heads
// head_offset .. + H of a layer of total_heads (0: H).
int tr_attention_keep_mask(const void* seed, uint32_t threshold, void* out,
                           int64_t B, int H, uint32_t head_offset,
                           uint32_t total_heads, int L, void* stream) {
  if (L % 4 != 0) return cudaErrorInvalidValue;
  if (total_heads == 0) total_heads = (uint32_t)H;
  if (head_offset + (uint32_t)H > total_heads) return cudaErrorInvalidValue;
  const int64_t n = B * H * L * (L / 4);
  if (n == 0) return 0;
  const int threads = 256;
  attention_keep_mask<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      make_dropout(seed, threshold, 1.f, head_offset, total_heads),
      static_cast<uint8_t*>(out), B, H, L);
  return cudaGetLastError();
}

const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
