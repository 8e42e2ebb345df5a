// Causal softmax attention with a key padding mask, backward, for Hopper
// (sm_90a): the dQ pass and the dK/dV pass.
//
// Replaces: the two backward kernels (dK/dV, dQ) of the Pallas TPU
// flash-attention kernel that textreact_tpu/models/layers.py::
// _flash_attention calls. What it computes and its bound are set out at the
// head of causal_attention.cu, beside the forward whose statistics it reads;
// the passes are those of fused_attention_bwd.cu (attention_bwd.cuh) with
// the causal flag set and no dropout: p = exp(s - m) / l below and on the
// diagonal and 0 above it, dS = p * (dO v^T - delta) * scale, delta =
// rowsum(dO * O). A block of query rows reads only the keys below its last
// row, a block of keys only the query rows from its first key on, so about
// half of the non-causal backward's arithmetic goes away (bytes bind as
// there: 8 * 25 MB at B=32, L=512, H=12, D=64 in bf16, 60 us). No atomics:
// a call is deterministic. bfloat16 takes the tensor-core kernels, float32
// the exact FMA kernels, as in fused_attention_bwd.cu; the dQ blocks with
// the most key tiles, and the dK/dV blocks with the most query tiles, are
// started first.

#include "attention_bwd.cuh"

namespace {

template <typename T>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const int32_t* mask, const void* stats,
                void* dq, void* dk, void* dv, void* delta, int B, int L, int H,
                int D, float scale, cudaStream_t stream) {
  const Dropout drop = make_dropout(nullptr, 0u, 1.f);
  const int W = kernel_width(D);  // D runs at this width (attention_common.cuh)
  if (W == 64) {
    return launch_bwd<T, 64, false, true>(q, k, v, o, dout, mask, stats, drop, dq,
                                          dk, dv, delta, nullptr, B, L, H, D, scale,
                                          stream);
  }
  if (W == 32) {
    return launch_bwd<T, 32, false, true>(q, k, v, o, dout, mask, stats, drop, dq,
                                          dk, dv, delta, nullptr, B, L, H, D, scale,
                                          stream);
  }
  if (W == 128) {
    return launch_bwd<T, 128, false, true>(q, k, v, o, dout, mask, stats, drop, dq,
                                           dk, dv, delta, nullptr, B, L, H, D, scale,
                                           stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o, dout, dq, dk, dv: (B, L,
// H * D) contiguous, 16-byte aligned, D a multiple of 8 up to 128; mask:
// (B, L) int32 {0, 1} or null; stats: (B, H, L, 2) float32 (row max,
// normaliser) as the causal forward wrote them; delta: (B, H, L) float32
// workspace. Returns cudaGetLastError() after the launches.

int tr_causal_attention_bwd(int dtype, const void* q, const void* k,
                            const void* v, const void* o, const void* dout,
                            const void* mask, const void* stats, void* dq,
                            void* dk, void* dv, void* delta, int B, int L,
                            int H, int D, float scale, void* stream) {
  const int32_t* m = static_cast<const int32_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (dtype == 0) {
    return bwd<float>(q, k, v, o, dout, m, stats, dq, dk, dv, delta, B, L, H, D,
                      scale, st);
  }
  if (dtype == 1) {
    return bwd<__nv_bfloat16>(q, k, v, o, dout, m, stats, dq, dk, dv, delta, B, L,
                              H, D, scale, st);
  }
  return cudaErrorInvalidValue;
}

const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
