// Self-attention under a per-example (B, L, L) admission mask, forward,
// for Hopper (sm_90a), and the two packing kernels it reads from.
//
// What it computes: the function of fused_attention.cu with the key mask
// replaced by a mask of (query, key) pairs, the template model's bond mask
// (models/encoder.py under --unattend_nonbonds): a barred pair adds -1e9 to
// its f32 score, as the plain path's additive bias does
// (models/layers.py::mask_to_bias), so a row with every key barred averages
// v as the plain path's does. The dropout mask is the plain path's own: one
// `torch.rand` of (B, total_heads, L, L) from the caller's generator,
// kept where the uniform is at least p (models/layers.py::dropout), cut to
// the call's heads. Both masks reach the kernels as bits:
// - `pack_bits` turns a (planes, L, L) array into words, admitted (or kept)
//   where an element is at least a threshold: 1 for an integer mask, p for
//   the uniforms. Its layout is the one the dQ pass of fused_attention_bwd.cu
//   leaves its keep bits in for the dK/dV pass: per plane, key tile of 64
//   and query row, two words, bit k % 32 of word (k % 64) / 32 for key k.
//   A thread reads 16 bytes at a time and the lanes of one word join their
//   bits by shuffles. The (B, L, L) mask is packed once a forward of the
//   encoder (1 MB at B=32 L=512), the uniforms once a call (12.6 MB of bits
//   from 403 MB).
// - the forward kernel is attention_fwd_tc with kBits (attention_fwd.cuh):
//   per key tile a lane reads the two words of its two rows from each
//   array, where the key-mask kernel reads the tile's key mask and draws
//   Philox bits. No key tile is left out: under this mask a tile that bars
//   every key of one row may admit keys of another.
// The bf16 tensor-core kernel only: the element type of the training and
// eval paths on the card. A float32 model keeps the plain path
// (models/layers.py::mask_3d_route).
//
// The backward passes are in mask3d_attention_bwd.cu.

#include "attention_fwd.cuh"

namespace {

constexpr int kPackThreads = 256;
constexpr int kPackLoads = 4;  // 16-byte loads in flight a thread

// out (planes, L / 64, L, 2) words from src (.., L, L): plane pl is source
// plane (pl / H) * total_heads + head_offset + pl % H (H = total_heads = 1
// for a (B, L, L) mask); bit set iff the element is >= threshold. A thread
// reads 16 bytes (N elements) at a time, kPackLoads loads in flight, and
// the 32 / N lanes that hold a word's elements join their bits by
// shuffles; a warp's loads are 32 N neighbouring elements, whole words of
// one row or more (L is a multiple of 128). Grid: (L^2 / elements a block,
// planes).
template <typename T>
__global__ void __launch_bounds__(kPackThreads)
pack_bits(const T* __restrict__ src, T threshold, uint32_t* __restrict__ out,
          int L, int H, int total_heads, int head_offset) {
  constexpr int N = 16 / (int)sizeof(T);  // elements a load
  constexpr int kLanes = 32 / N;          // lanes a word
  const int pl = blockIdx.y;
  const int64_t plane = (int64_t)(pl / H) * total_heads + head_offset + pl % H;
  const T* base = src + plane * L * L;
  uint32_t* words = out + (int64_t)pl * (L / kTcTile) * L * 2;
  const int lane = threadIdx.x & 31;
  const int64_t first =
      ((int64_t)blockIdx.x * kPackLoads * kPackThreads + threadIdx.x) * N;
  uint4 raw[kPackLoads];
#pragma unroll
  for (int i = 0; i < kPackLoads; ++i) {
    raw[i] = *reinterpret_cast<const uint4*>(base + first + i * kPackThreads * N);
  }
#pragma unroll
  for (int i = 0; i < kPackLoads; ++i) {
    const T* e = reinterpret_cast<const T*>(&raw[i]);
    uint32_t bits = 0u;
#pragma unroll
    for (int j = 0; j < N; ++j) bits |= (uint32_t)(e[j] >= threshold) << j;
    bits <<= N * (lane % kLanes);
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) bits |= __shfl_xor_sync(kFullWarp, bits, o);
    if (lane % kLanes == 0) {
      const int64_t at = first + i * kPackThreads * N;  // the word's key 0
      const int r = (int)(at / L), k = (int)(at % L);
      words[((int64_t)(k / kTcTile) * L + r) * 2 + ((k >> 5) & 1)] = bits;
    }
  }
}

template <typename T>
cudaError_t launch_pack(const void* src, T threshold, void* out, int planes,
                        int L, int H, int total_heads, int head_offset,
                        cudaStream_t stream) {
  constexpr int per_block = kPackLoads * kPackThreads * (16 / (int)sizeof(T));
  if (L % 128 != 0 || H <= 0 || planes % H != 0 || planes > 65535 ||
      head_offset + H > total_heads || (int64_t)L * L % per_block != 0) {
    return cudaErrorInvalidValue;
  }
  if (planes == 0) return cudaSuccess;
  pack_bits<T><<<dim3((unsigned)((int64_t)L * L / per_block), planes),
                 kPackThreads, 0, stream>>>(
      static_cast<const T*>(src), threshold, static_cast<uint32_t*>(out), L, H,
      total_heads, head_offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The admission bits of a (B, L, L) mask `mask`, 1 where the element is
// above 0: elem 8 (int64) or 4 (int32); out (B, L / 64, L, 2) uint32.
int tr_pack_mask_bits(const void* mask, int elem, void* out, int B, int L,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == 8) return launch_pack<int64_t>(mask, 1, out, B, L, 1, 1, 0, st);
  if (elem == 4) return launch_pack<int32_t>(mask, 1, out, B, L, 1, 1, 0, st);
  return cudaErrorInvalidValue;
}

// The keep bits of heads head_offset .. + H of uniforms `u` (B,
// total_heads, L, L) float32, 1 where u >= p: out (B, H, L / 64, L, 2).
int tr_pack_keep_bits(const void* u, float p, void* out, int B, int H,
                      int total_heads, int head_offset, int L, void* stream) {
  return launch_pack<float>(u, p, out, B * H, L, H, total_heads, head_offset,
                            static_cast<cudaStream_t>(stream));
}

// q, k, v, out: (B, L, H * D) bfloat16 (dtype 1), D a multiple of 8 up to
// 128; admit: (B, L / 64, L, 2) words of tr_pack_mask_bits; keep: (B, H,
// L / 64, L, 2) words of tr_pack_keep_bits, or null for no dropout, the kept
// weights scaled by inv_keep; stats: (B, H, L, 2) float32 or null.
int tr_attention_fwd_bits(int dtype, const void* q, const void* k,
                          const void* v, const void* admit, const void* keep,
                          void* out, void* stats, float inv_keep, int B, int L,
                          int H, int D, float scale, void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Dropout drop = make_dropout(nullptr, 0u, keep == nullptr ? 1.f : inv_keep);
  const uint32_t* a = static_cast<const uint32_t*>(admit);
  const uint32_t* kp = static_cast<const uint32_t*>(keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool dropout = keep != nullptr;
#define TR_FWD_BITS(WV, DR)                                                    \
  return launch_fwd_bits<WV, DR>(q, k, v, a, kp, out, stats, drop, B, L, H, D, \
                                 scale, st);
  TR_DISPATCH(TR_FWD_BITS);
#undef TR_FWD_BITS
  return cudaErrorInvalidValue;
}

const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
