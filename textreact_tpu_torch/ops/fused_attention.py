"""Fused non-causal attention (twin of textreact_tpu/ops/fused_attention.py).

softmax(q k^T * sm_scale + mask_bias) v over the (B, L, H, D) layout, where
a key with mask 0 gets the additive bias -1e9 (not -inf: the collator's
dummy rows have every key masked and must stay finite, or NaN reaches the
beam search's top-k). Attention-probability dropout keeps the softmax
normaliser over the undropped weights (torch/HF semantics).

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/fused_attention.cu, forward at p = 0) or raises; on a CPU tensor it
runs the plain version below.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NEG_INF = -1e9
SUPPORTED_HEAD_DIM = (32, 64)
SEQ_MULTIPLE = 128  # the kernel's query tile
LAUNCHES = 0  # kernel launches since the last reset

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"tr_attention_fwd": [
    _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P]}


def load_kernel():
    """Build (at first use) and load the kernel's library."""
    return _build.load("fused_attention", _SIGNATURES)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask_kv: Optional[torch.Tensor], sm_scale: float,
                        keep: Optional[torch.Tensor] = None,
                        dropout_p: float = 0.0) -> torch.Tensor:
    """Plain version of the kernel (ops/fused_attention.py:_fwd_kernel).

    q, k, v: (B, L, H, D); mask_kv: (B, L) {0, 1} or None; keep: optional
    (B, H, L, L) bool dropout keep mask. Scores and the softmax in f32; the
    unnormalised weights meet v in v's dtype and 1/l scales the context."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if mask_kv is not None:
        bias = torch.where(mask_kv > 0, 0.0, NEG_INF).to(torch.float32)
        s = s + bias[:, None, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l = e.sum(-1, keepdim=True)
    inv = 1.0
    if keep is not None:
        e = torch.where(keep, e, 0.0)
        inv = 1.0 / (1.0 - dropout_p)
    ctx = torch.einsum("bhqk,bkhd->bhqd", e.to(v.dtype).float(), v.float())
    ctx = ctx * (inv / l)
    return ctx.transpose(1, 2).to(q.dtype)


def fused_dropout_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask_kv: Optional[torch.Tensor],
                            dropout_p: float = 0.0,
                            generator: Optional[torch.Generator] = None,
                            sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, L, H, D) inputs; returns (B, L, H, D) in q's dtype."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        keep = None
        if dropout_p > 0.0:
            B, L, H, _ = q.shape
            keep = torch.rand((B, H, L, k.shape[1]),
                              generator=generator) >= dropout_p
        return attention_reference(q, k, v, mask_kv, sm_scale, keep,
                                   dropout_p)
    return _launch(q, k, v, mask_kv, dropout_p, sm_scale)


def _launch(q, k, v, mask_kv, dropout_p, sm_scale):
    global LAUNCHES
    if dropout_p > 0.0:
        raise NotImplementedError(
            "fused_dropout_attention kernel: dropout comes with training")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "fused_dropout_attention kernel: no backward yet")
    if q.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"fused_dropout_attention: dtype {q.dtype}")
    B, L, H, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"fused_dropout_attention: {name} is "
                             f"{t.dtype}{tuple(t.shape)}, q is "
                             f"{q.dtype}{tuple(q.shape)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"fused_dropout_attention: {name} must be a "
                             f"contiguous tensor on {q.device}")
    if D not in SUPPORTED_HEAD_DIM or L % SEQ_MULTIPLE != 0:
        raise ValueError(f"fused_dropout_attention: head dim {D} not in "
                         f"{SUPPORTED_HEAD_DIM} or length {L} not a multiple "
                         f"of {SEQ_MULTIPLE}")
    mask = None
    if mask_kv is not None:
        if mask_kv.shape != (B, L) or mask_kv.device != q.device:
            raise ValueError(f"fused_dropout_attention: mask "
                             f"{tuple(mask_kv.shape)} on {mask_kv.device}")
        mask = mask_kv.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = load_kernel()
    err = lib.tr_attention_fwd(
        _build.DTYPE_CODE[q.dtype], _build.ptr(q), _build.ptr(k),
        _build.ptr(v), None if mask is None else _build.ptr(mask),
        _build.ptr(out), B, L, H, D, float(sm_scale), _build.stream())
    _build.check(lib, err, "fused_dropout_attention")
    LAUNCHES += 1
    return out
