// Causal softmax attention with a key padding mask, forward, for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU flash-attention kernel that
// textreact_tpu/models/layers.py::_flash_attention calls
// (jax.experimental.pallas.ops.tpu.flash_attention, forward), as the JAX
// package uses it: causal, the key mask given as segment ids, no dropout,
// sm_scale = 1 / sqrt(D). out = softmax(q k^T * scale + mask) v per (batch,
// head), where query row i sees keys 0 .. i, and a key with mask 0 gets the
// additive bias -1e9 as in the non-causal kernel. A key above the diagonal
// has weight exactly 0, whatever the key mask says: a row whose visible keys
// are all masked (a collator dummy row) is uniform over keys 0 .. i and
// stays finite. Wherever a row has one admissible key, which is every real
// row of a right-padded batch, this equals the TPU kernel, which adds one
// large negative value where "same segment and causal" is false.
//
// What differs from the TPU kernel: it runs over (B, H, L, D) in blocks of
// min(512, L) and skips the blocks above the diagonal; its caller transposes
// q, k, v in and the result out. Here q, k, v and out stay in the model's
// (B, L, H * D) activation layout, so no transpose runs around a call, and
// the skipping is the loop bound of the kernels in attention_fwd.cuh: a
// block of query rows streams the key tiles up to its diagonal only, and the
// blocks with the most tiles are started first, so that the card's last wave
// is made of the short ones. Segment ids do not exist here: the key mask is
// the (B, L) int32 array itself.
//
// The two paths of fused_attention.cu, chosen by the element type alone:
// bfloat16 takes the tensor-core kernel (`mma.sync` products, 64 query rows
// a block, key tiles of 64, the diagonal tile masked with -inf in the
// accumulators), float32 the exact FMA kernel (128 rows a block).
//
// Bound at the decoder shape (B=32, L=512, H=12, D=64, bf16): the bytes of
// the non-causal kernel (4 * 25 MB moved, 30 us) and about half its
// operations (the triangle: 2 * B * H * D * L * (L + 64) = 14.5 GFLOP for
// the tiles the bf16 kernel visits, 15 us at the bf16 tensor-core peak):
// bytes bind.

#include "attention_fwd.cuh"

namespace {

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, const int32_t* mask,
                void* out, void* stats, int B, int L, int H, int D, float scale,
                cudaStream_t stream) {
  const Dropout drop = make_dropout(nullptr, 0u, 1.f);
  const int W = kernel_width(D);  // D runs at this width (attention_common.cuh)
  if (W == 64) {
    return launch_fwd<T, 64, false, true>(q, k, v, mask, out, stats, drop, B, L, H, D,
                                          scale, stream);
  }
  if (W == 32) {
    return launch_fwd<T, 32, false, true>(q, k, v, mask, out, stats, drop, B, L, H, D,
                                          scale, stream);
  }
  if (W == 128) {
    return launch_fwd<T, 128, false, true>(q, k, v, mask, out, stats, drop, B, L, H, D,
                                           scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out: (B, L, H * D) contiguous,
// D a multiple of 8 up to 128;
// mask: (B, L) int32 {0, 1} or null; stats: (B, H, L, 2) float32 (row max,
// normaliser) or null. Returns cudaGetLastError() after the launch.

int tr_causal_attention_fwd(int dtype, const void* q, const void* k,
                            const void* v, const void* mask, void* out,
                            void* stats, int B, int L, int H, int D,
                            float scale, void* stream) {
  const int32_t* m = static_cast<const int32_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (dtype == 0) return fwd<float>(q, k, v, m, out, stats, B, L, H, D, scale, st);
  if (dtype == 1) {
    return fwd<__nv_bfloat16>(q, k, v, m, out, stats, B, L, H, D, scale, st);
  }
  return cudaErrorInvalidValue;
}

const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
