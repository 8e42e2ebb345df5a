// Counter-based dropout bits shared by the attention and LayerNorm kernels.
//
// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11), keyed by the call's 64-bit seed. The counter is built from the
// ELEMENT's coordinates, never from the block or thread that happens to
// compute it, so a forward kernel and a backward kernel with different
// tilings draw the same bit for the same element. One call yields four
// 32-bit words: the four neighbouring columns 4 * (col / 4) .. + 3, of which
// an element takes word col % 4.
//
// Keep rule (the TPU kernels' rule, textreact_tpu/ops/fused_attention.py:
// 42-47): keep iff bits >= threshold, threshold = min(int(p * 2^32), 2^32-1).

#pragma once

#include <stdint.h>

namespace tr {

__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t c3,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t out[4]) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// Attention probabilities: element (bh = batch * H + head, query row, key
// column), H and head counted over the layer's heads (dropout_head below).
// `col4` is column / 4; the words are columns 4 * col4 .. + 3.
__device__ __forceinline__ void attention_bits(uint64_t seed, uint32_t bh,
                                               uint32_t row, uint32_t col4,
                                               uint32_t out[4]) {
  philox4x32_10(col4, row, bh, 0u, (uint32_t)seed, (uint32_t)(seed >> 32), out);
}

// Residual rows: element (row, column); the row index may exceed 32 bits.
__device__ __forceinline__ void row_bits(uint64_t seed, uint64_t row,
                                         uint32_t col4, uint32_t out[4]) {
  philox4x32_10(col4, (uint32_t)row, (uint32_t)(row >> 32), 1u, (uint32_t)seed,
                (uint32_t)(seed >> 32), out);
}

// What a kernel is told about its dropout; `seed` null means none.
// A call may compute heads head_offset .. + H of a layer with total_heads
// heads (a tensor-parallel rank's share): its masks are then those of those
// heads in the whole layer, never those of heads 0 .. H - 1.
struct Dropout {
  const int64_t* seed;   // one 64-bit seed in device memory, or null
  uint32_t threshold;    // keep iff bits >= threshold
  float inv_keep;        // 1 / (1 - p)
  uint32_t head_offset;  // the layer's head of this call's head 0
  uint32_t total_heads;  // the layer's heads
};

inline Dropout make_dropout(const void* seed, uint32_t threshold, float inv_keep,
                            uint32_t head_offset = 0, uint32_t total_heads = 0) {
  Dropout d;
  d.seed = static_cast<const int64_t*>(seed);
  d.threshold = threshold;
  d.inv_keep = inv_keep;
  d.head_offset = head_offset;
  d.total_heads = total_heads;
  return d;
}

// The Philox coordinate bh of this call's (batch b, head h): b * total_heads
// + head_offset + h.
__device__ __forceinline__ uint32_t dropout_head(const Dropout& d, int b, int h) {
  return (uint32_t)b * d.total_heads + d.head_offset + (uint32_t)h;
}

}  // namespace tr
