"""The grouped beam decode's self-attention over the row-stable cache, one
decode step (models/layers.py::MultiHeadAttention.decode_self_grouped).

For each (example, head) pair, its G beams' queries attend over the cache's
prefix of WG = W * G keys under the ancestry bias:

    softmax(q k^T * sm_scale + bias) v

q: (Bex*H, G, D) in the compute dtype; cache_k, cache_v: the (Bex, H, D,
T*G) caches, keys last, read in place through their prefix [..., :WG];
beam_bias: the (Bex, G, WG) float32 table of inference/beam.py::
ancestor_bias (0 where a beam sees a row, -1e9 elsewhere), shared by an
example's heads. The result is the context (Bex*H, G, D) in q's dtype.

`grouped_decode_attention` launches the hand-written kernel
(csrc/decode_attention.cu) on CUDA tensors and raises on others;
`grouped_decode_attention_reference` is the plain version (two batched
products around the scores' scale, bias, softmax and casts), the CPU path
and the kernel's oracle. The JAX package has no such kernel (XLA computes
its step). The element type picks the kernel's route: bfloat16 the
tensor-core one, float32 the exact FMA one. With `round_scores` the scores
are rounded to q's dtype before they are scaled, as a product stored in
the compute dtype is (decode_scores_dtype "bfloat16"). Both routes take
any head dim up to MAX_HEAD_DIM (models/factory.py::check_kernel_shapes
refuses a decoder past it on the card).

The kernel runs one block a (example, head, row group of beams) over the
whole key axis. It launches on the current stream and allocates nothing
but its output, through torch, so it can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import span
from . import _build

DECODE_LAUNCHES = 0  # kernel launches since the last reset
MAX_HEAD_DIM = 128  # the widest of the bf16 route's widths (TR_DECODE_MMA)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "tr_grouped_decode_attn": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               ctypes.c_int64, ctypes.c_float, _I, _P],
}


def load_kernel():
    """Build (at first use) and load the kernel's library."""
    return _build.load("decode_attention", _SIGNATURES)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 accumulation and output, for inputs in any dtype
    (preferred_element_type=float32 in the JAX package)."""
    return torch.matmul(a.float(), b.float())


def _decode_bmm(a: torch.Tensor, b: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    """Batched a @ b of the decode attention: (N, m, k) @ (N, k, n) ->
    (N, m, n) in `out_dtype`, f32 accumulation (`preferred_element_type`
    in the JAX package). On the card the operands are read in place in
    their own dtype: a product into their dtype is cuBLAS's bmm, one into
    f32 from bf16 its `out_dtype` overload. On the CPU the plain route
    up-casts both to f32 (bf16 products are exact in f32, so the two differ
    in summation order only) and rounds the result to `out_dtype`."""
    with span("decode.products"):
        if a.device.type != "cuda":
            return _matmul_f32(a, b).to(out_dtype)
        if out_dtype == a.dtype:
            return torch.bmm(a, b)
        return torch.bmm(a, b, out_dtype=out_dtype)


def grouped_decode_attention_reference(q: torch.Tensor,
                                       cache_k: torch.Tensor,
                                       cache_v: torch.Tensor,
                                       beam_bias: torch.Tensor,
                                       sm_scale: float,
                                       round_scores: bool) -> torch.Tensor:
    """The plain version: scores stored in q's dtype (`round_scores`) or
    in f32, then scaled, biased and softmaxed in f32; the probabilities in
    q's dtype meet V."""
    Bex, H, D = cache_k.shape[:3]
    G, WG = q.shape[1], beam_bias.shape[-1]
    k = cache_k[..., :WG].view(Bex * H, D, WG)    # views: no copy
    v = cache_v[..., :WG].view(Bex * H, D, WG)
    s_dt = q.dtype if round_scores else torch.float32
    s = _decode_bmm(q, k, s_dt).view(Bex, H, G, WG)
    s = s.float() * sm_scale + beam_bias[:, None]
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    return _decode_bmm(probs.view(Bex * H, G, WG), v.transpose(1, 2),
                       q.dtype)                         # (Bex*H, G, D)


def _check(q, cache_k, cache_v, beam_bias) -> None:
    """Validate the kernel's preconditions."""
    tensors = (("q", q), ("cache_k", cache_k), ("cache_v", cache_v),
               ("beam_bias", beam_bias))
    for name, t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"grouped_decode_attention: {name} on {t.device}"
                             "; the plain version is "
                             "grouped_decode_attention_reference")
        if not t.is_contiguous():
            raise ValueError(f"grouped_decode_attention: {name} must be "
                             "contiguous")
    if q.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"grouped_decode_attention: dtype {q.dtype}")
    if cache_k.dtype != q.dtype or cache_v.dtype != q.dtype:
        raise TypeError("grouped_decode_attention: q, cache_k and cache_v "
                        "must share a dtype")
    if beam_bias.dtype != torch.float32:
        raise TypeError("grouped_decode_attention: beam_bias must be float32")
    if cache_k.dim() != 4 or cache_v.shape != cache_k.shape:
        raise ValueError(f"cache_k {tuple(cache_k.shape)} vs cache_v "
                         f"{tuple(cache_v.shape)}: (Bex, H, D, T*G) each")
    Bex, H, D, TG = cache_k.shape
    if q.dim() != 3 or q.shape[0] != Bex * H or q.shape[2] != D:
        raise ValueError(f"q {tuple(q.shape)} for a cache of "
                         f"{tuple(cache_k.shape)}")
    G = q.shape[1]
    if (beam_bias.dim() != 3 or beam_bias.shape[:2] != (Bex, G)
            or not 0 < beam_bias.shape[2] <= TG):
        raise ValueError(f"beam_bias {tuple(beam_bias.shape)}: (Bex, G, WG) "
                         f"with WG up to {TG}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"grouped_decode_attention: head dim {D} above "
                         f"{MAX_HEAD_DIM}")


def grouped_decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                             cache_v: torch.Tensor, beam_bias: torch.Tensor,
                             sm_scale: float,
                             round_scores: bool) -> torch.Tensor:
    """The context (Bex*H, G, D) in q's dtype, from the kernel; raises on
    tensors off the card. The bias must admit a key in every row (as
    ancestor_bias admits position 0): keys masked in every row are skipped
    by whole tiles (csrc/decode_attention.cu)."""
    global DECODE_LAUNCHES
    _check(q, cache_k, cache_v, beam_bias)
    Bex, H, D, TG = cache_k.shape
    G, WG = q.shape[1], beam_bias.shape[-1]
    out = torch.empty_like(q)
    lib = load_kernel()
    err = lib.tr_grouped_decode_attn(
        _build.DTYPE_CODE[q.dtype], _build.ptr(q), _build.ptr(cache_k),
        _build.ptr(cache_v), _build.ptr(beam_bias), _build.ptr(out), Bex, H,
        G, D, WG, TG, float(sm_scale),
        int(bool(round_scores) and q.dtype != torch.float32), _build.stream())
    _build.check(lib, err, "grouped_decode_attention")
    DECODE_LAUNCHES += 1
    return out
