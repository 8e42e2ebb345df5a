// Self-attention under a per-example (B, L, L) admission mask, backward,
// for Hopper (sm_90a): the dQ pass and the dK/dV pass of
// fused_attention_bwd.cu with kBits (attention_bwd.cuh), over the packed
// admission bits and the packed keep bits of the forward
// (mask3d_attention.cu). Both passes read the keep bits, so the backward
// draws nothing and writes no bits; the dK/dV pass copies a query tile's
// admission words of its 64 keys in beside their keep words, in the same
// layout. No key tile or key block is left out.

#include "attention_bwd.cuh"

extern "C" {

// q, k, v, o, dout, dq, dk, dv: (B, L, H * D) bfloat16 (dtype 1), 16-byte
// aligned, D a multiple of 8 up to 128; admit, keep, inv_keep as the forward
// (tr_attention_fwd_bits) took them; stats: (B, H, L, 2) float32 as the
// forward wrote them; delta: (B, H, L) float32 workspace.
int tr_attention_bwd_bits(int dtype, const void* q, const void* k,
                          const void* v, const void* o, const void* dout,
                          const void* admit, const void* stats,
                          const void* keep, float inv_keep, void* dq, void* dk,
                          void* dv, void* delta, int B, int L, int H, int D,
                          float scale, void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Dropout drop = make_dropout(nullptr, 0u, keep == nullptr ? 1.f : inv_keep);
  const uint32_t* a = static_cast<const uint32_t*>(admit);
  const uint32_t* kp = static_cast<const uint32_t*>(keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool dropout = keep != nullptr;
#define TR_BWD_BITS(WV, DR)                                                    \
  return launch_bwd_bits<WV, DR>(q, k, v, o, dout, a, stats, kp, drop, dq, dk, \
                                 dv, delta, B, L, H, D, scale, st);
  TR_DISPATCH(TR_BWD_BITS);
#undef TR_BWD_BITS
  return cudaErrorInvalidValue;
}

const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
