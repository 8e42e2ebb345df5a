"""Fused attention: non-causal with dropout (twin of
textreact_tpu/ops/fused_attention.py) and causal without (twin of
textreact_tpu/models/layers.py::_flash_attention).

softmax(q k^T * sm_scale + mask_bias) v over the (B, L, H, D) layout, where
a key with mask 0 gets the additive bias -1e9 (not -inf: the collator's
dummy rows have every key masked and must stay finite, or NaN reaches the
beam search's top-k). Attention-probability dropout keeps the softmax
normaliser over the undropped weights (torch/HF semantics).

On a CUDA tensor the wrapper launches the hand-written kernels
(csrc/fused_attention.cu: forward; csrc/fused_attention_bwd.cu: a backward
of two passes; joined by a `torch.autograd.Function`) or raises; on a CPU
tensor it runs the plain version below under ordinary autograd. The element
type alone picks the kernels: bfloat16, the type of the serving and training
paths on the card, takes the tensor-core kernels (every product an
`mma.sync` of bf16 into f32, the weights and dS rounded to bf16 before
their second product, as `attention_rounding_reference` states in plain
PyTorch); float32 takes the exact kernels (f32 FMA arithmetic throughout,
right to summation order). Nothing falls back from one to the other. Key
tiles that hold no valid key are not visited where that changes no bit of
the result. The kernels draw their dropout bits
from a counter-based generator keyed by one 64-bit seed per call
(csrc/philox.cuh); the seed is drawn from the caller's `torch.Generator`,
stays on the device, and is saved for the backward, which regenerates the
mask (the tensor-core backward draws it in its dQ pass and hands the bits to
its dK/dV pass through a workspace). `keep_mask` exports that mask for
tests.

`causal_attention` is the causal call: query row i sees keys 0 .. i, no
dropout. Its kernels (csrc/causal_attention.cu, csrc/causal_attention_bwd.cu)
are the same device functions with the causal flag set, so a block of query
rows streams only the key tiles at or below its diagonal, and the blocks
with the most tiles start first.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

NEG_INF = -1e9
SUPPORTED_HEAD_DIM = (32, 64, 128)  # TR_DISPATCH in csrc/attention_common.cuh
HEAD_DIM_MULTIPLE = 8  # other head dims run zero-padded to the next width
SEQ_MULTIPLE = 128  # the kernels' row tile
LAUNCHES = 0      # forward kernel launches since the last reset
BWD_LAUNCHES = 0  # backward launches (one per dQ + dK/dV pair)
CAUSAL_LAUNCHES = 0      # the same two counts for the causal kernels
CAUSAL_BWD_LAUNCHES = 0
# the same four counts for calls whose head dim was zero-padded
PADDED_LAUNCHES = {"fwd": 0, "bwd": 0, "causal_fwd": 0, "causal_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
# one library per source, so that the four compile side by side
LIBRARIES = ("fused_attention", "fused_attention_bwd", "causal_attention",
             "causal_attention_bwd")
_SIGNATURES = {
    "tr_attention_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _U, _F, _U, _U,
                         _I, _I, _I, _I, _F, _P],
    "tr_attention_keep_mask": [_P, _U, _P, ctypes.c_int64, _I, _U, _U, _I,
                               _P],
}
_BWD_SIGNATURES = {
    "tr_attention_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _U, _F, _U, _U,
                         _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}


_CAUSAL_SIGNATURES = {
    "tr_causal_attention_fwd": [_I, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _F, _P],
}
_CAUSAL_BWD_SIGNATURES = {
    "tr_causal_attention_bwd": [_I, _P, _P, _P, _P, _P, _P, _P,
                                _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}


def kernel_head_dim(D: int) -> int:
    """The instantiated width that head dim D runs at: the least of
    SUPPORTED_HEAD_DIM that holds it, for a multiple of HEAD_DIM_MULTIPLE;
    0 for a head dim the kernels do not take. Past 128 the dK/dV pass
    already spills its registers at 128 (csrc/attention_bwd.cuh)."""
    if D <= 0 or D % HEAD_DIM_MULTIPLE:
        return 0
    return next((w for w in SUPPORTED_HEAD_DIM if D <= w), 0)


def load_kernel():
    """Build (at first use) and load the forward's library."""
    return _build.load("fused_attention", _SIGNATURES)


def load_bwd_kernel():
    """Build (at first use) and load the backward's library."""
    return _build.load("fused_attention_bwd", _BWD_SIGNATURES)


def load_causal_kernel():
    """Build (at first use) and load the causal forward's library."""
    return _build.load("causal_attention", _CAUSAL_SIGNATURES)


def load_causal_bwd_kernel():
    """Build (at first use) and load the causal backward's library."""
    return _build.load("causal_attention_bwd", _CAUSAL_BWD_SIGNATURES)


def _weights(q, k, mask_kv, sm_scale, causal):
    """(unnormalised softmax weights (B, H, L, L), their row sums), f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if mask_kv is not None:
        bias = torch.where(mask_kv > 0, 0.0, NEG_INF).to(torch.float32)
        s = s + bias[:, None, None, :]
    if causal:
        Lq, Lk = s.shape[-2:]
        above = torch.ones(Lq, Lk, dtype=torch.bool,
                           device=s.device).triu(diagonal=1)
        s = s.masked_fill(above, float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e, e.sum(-1, keepdim=True)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask_kv: Optional[torch.Tensor], sm_scale: float,
                        keep: Optional[torch.Tensor] = None,
                        dropout_p: float = 0.0,
                        causal: bool = False) -> torch.Tensor:
    """Plain version of the kernels (ops/fused_attention.py:_fwd_kernel;
    with `causal`, the flash kernel behind layers.py:_flash_attention).

    q, k, v: (B, L, H, D); mask_kv: (B, L) {0, 1} or None; keep: optional
    (B, H, L, L) bool dropout keep mask. Scores and the softmax in f32; the
    unnormalised weights meet v in v's dtype and 1/l scales the context.
    `causal`: a key above the diagonal scores -inf, so its weight is exactly
    0 whatever the key mask says (every row sees key 0, so no row is empty);
    the key mask stays the additive -1e9."""
    e, l = _weights(q, k, mask_kv, sm_scale, causal)
    inv = 1.0
    if keep is not None:
        e = torch.where(keep, e, 0.0)
        inv = 1.0 / (1.0 - dropout_p)
    ctx = torch.einsum("bhqk,bkhd->bhqd", e.to(v.dtype).float(), v.float())
    ctx = ctx * (inv / l)
    return ctx.transpose(1, 2).to(q.dtype)


def attention_rounding_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, dout: torch.Tensor,
                                 mask_kv: Optional[torch.Tensor],
                                 sm_scale: float,
                                 keep: Optional[torch.Tensor] = None,
                                 dropout_p: float = 0.0,
                                 causal: bool = False,
                                 out: Optional[torch.Tensor] = None):
    """Forward and backward of the tensor-core kernels written out in plain
    PyTorch with the kernels' rounding points, for tests: returns (out, dq,
    dk, dv) in q's dtype. `out`, (B, L, H, D): the forward output that the
    backward reads for delta = rowsum(dO out), as the kernels' backward and
    the TPU kernel's (o_ref) read the forward's; default the statement's own.

    Every product takes operands of q's dtype and sums in f32. The
    unnormalised weights are rounded to q's dtype before they meet v (as in
    `attention_reference`); in the backward dV is (E keep)^T (dO inv / l)
    with both factors rounded, E the unnormalised weights and l their row
    sums, and dS is rounded before it meets k and q. These are the TPU
    kernel's rounding points (ops/fused_attention.py:_bwd_kernel :140-141
    and :156); autograd through `attention_reference` keeps all three in
    f32."""
    dt = q.dtype
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
    e, l = _weights(q, k, mask_kv, sm_scale, causal)
    inv = 1.0 if keep is None else 1.0 / (1.0 - dropout_p)
    kept = e if keep is None else torch.where(keep, e, 0.0)
    ctx = torch.einsum("bhqk,bkhd->bhqd", kept.to(dt).float(), vf) * (inv / l)
    own = ctx.transpose(1, 2).to(dt)
    read = own if out is None else out

    prob = e / l
    delta = (gf * read.float()).sum(-1).transpose(1, 2)[..., None]  # b h q 1
    dprob = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    if keep is not None:
        dprob = torch.where(keep, dprob * inv, 0.0)
    ds = (prob * (dprob - delta) * sm_scale).to(dt).float()
    row_scale = (inv / l)[..., 0].transpose(1, 2)[..., None]  # b q h 1
    dv = torch.einsum("bhqk,bqhd->bkhd", kept.to(dt).float(),
                      (gf * row_scale).to(dt).float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return own, dq.to(dt), dk.to(dt), dv.to(dt)


def fused_dropout_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask_kv: Optional[torch.Tensor],
                            dropout_p: float = 0.0,
                            generator: Optional[torch.Generator] = None,
                            sm_scale: Optional[float] = None,
                            keep: Optional[torch.Tensor] = None,
                            head_offset: int = 0,
                            total_heads: Optional[int] = None
                            ) -> torch.Tensor:
    """Attention over (B, L, H, D) inputs; returns (B, L, H, D) in q's dtype.

    Differentiable in q, k, v. With dropout_p > 0 the mask comes from
    `generator` (its device must be the tensors'); `keep`, an explicit
    (B, H, L, L) bool mask, is for CPU tensors only. The H heads are heads
    head_offset .. + H of a layer of `total_heads` (default H), as a
    tensor-parallel rank holds them: their masks are that layer's masks of
    those heads."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    B, L, H, _ = q.shape
    total_heads = H if total_heads is None else total_heads
    if not 0 <= head_offset <= total_heads - H:
        raise ValueError(f"fused_dropout_attention: heads {head_offset} .. "
                         f"+ {H} of {total_heads}")
    if not q.is_cuda:
        if dropout_p > 0.0 and keep is None:
            keep = torch.rand((B, total_heads, L, k.shape[1]),
                              generator=generator) >= dropout_p
            keep = keep[:, head_offset:head_offset + H]
        return attention_reference(q, k, v, mask_kv, sm_scale,
                                   keep if dropout_p > 0.0 else None,
                                   dropout_p)
    if keep is not None:
        raise ValueError("fused_dropout_attention: the kernel draws its own "
                         "mask; keep= is for CPU tensors")
    mask = _check(q, k, v, mask_kv)
    seed = _build.draw_seed(generator, q.device) if dropout_p > 0.0 else None
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    return _FusedAttention.apply(q, k, v, mask, seed, float(dropout_p),
                                 float(sm_scale), needs_grad, False,
                                 (head_offset, total_heads))


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask_kv: Optional[torch.Tensor],
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention over (B, L, H, D) inputs with a (B, L) key mask;
    returns (B, L, H, D) in q's dtype. Twin of
    textreact_tpu/models/layers.py::_flash_attention with causal=True: the
    key mask is what that function turns into segment ids, there is no
    dropout (the JAX package applies none on this branch, even in training),
    and the (B, L, H, D) layout is kept, so its four transposes are gone.

    Differentiable in q, k, v. On a CUDA tensor it launches the causal
    kernels or raises; on a CPU tensor it runs `attention_reference`."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return attention_reference(q, k, v, mask_kv, sm_scale, causal=True)
    mask = _check(q, k, v, mask_kv)
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    return _FusedAttention.apply(q, k, v, mask, None, 0.0, float(sm_scale),
                                 needs_grad, True, (0, q.shape[2]))


def keep_mask(seed: torch.Tensor, B: int, H: int, L: int,
              dropout_p: float, head_offset: int = 0,
              total_heads: Optional[int] = None) -> torch.Tensor:
    """The (B, H, L, L) bool keep mask the kernels draw for `seed` (a (1,)
    int64 CUDA tensor) and heads head_offset .. + H of `total_heads`
    (default H), written by the library's test-only entry point."""
    out = torch.empty((B, H, L, L), dtype=torch.uint8, device=seed.device)
    lib = load_kernel()
    err = lib.tr_attention_keep_mask(
        _build.ptr(seed), _build.dropout_threshold(dropout_p),
        _build.ptr(out), B, H, head_offset,
        H if total_heads is None else total_heads, L, _build.stream())
    _build.check(lib, err, "attention keep mask")
    return out.bool()


def _check(q, k, v, mask_kv) -> Optional[torch.Tensor]:
    """Validate the kernels' preconditions; returns the int32 mask."""
    if q.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"fused_dropout_attention: dtype {q.dtype}")
    B, L, H, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"fused_dropout_attention: {name} is "
                             f"{t.dtype}{tuple(t.shape)}, q is "
                             f"{q.dtype}{tuple(q.shape)}")
        if (t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16 != 0):
            raise ValueError(f"fused_dropout_attention: {name} must be a "
                             f"contiguous, 16-byte aligned tensor on "
                             f"{q.device}")
    if not kernel_head_dim(D) or L % SEQ_MULTIPLE != 0:
        raise ValueError(f"fused_dropout_attention: head dim {D} not a "
                         f"multiple of {HEAD_DIM_MULTIPLE} up to "
                         f"{SUPPORTED_HEAD_DIM[-1]} or length {L} not a "
                         f"multiple of {SEQ_MULTIPLE}")
    if mask_kv is None:
        return None
    if mask_kv.shape != (B, L) or mask_kv.device != q.device:
        raise ValueError(f"fused_dropout_attention: mask "
                         f"{tuple(mask_kv.shape)} on {mask_kv.device}")
    mask = mask_kv.to(torch.int32).contiguous()
    # the kernels copy the mask 16 bytes at a time
    return mask if mask.data_ptr() % 16 == 0 else mask.clone()


def _count(padded: bool, causal: bool, bwd: bool) -> None:
    """One launch of the kernel that (padded, causal, bwd) names."""
    global LAUNCHES, BWD_LAUNCHES, CAUSAL_LAUNCHES, CAUSAL_BWD_LAUNCHES
    if padded:
        PADDED_LAUNCHES[("causal_" if causal else "")
                        + ("bwd" if bwd else "fwd")] += 1
    elif causal and bwd:
        CAUSAL_BWD_LAUNCHES += 1
    elif causal:
        CAUSAL_LAUNCHES += 1
    elif bwd:
        BWD_LAUNCHES += 1
    else:
        LAUNCHES += 1


def _pad_heads(width: int, *tensors):
    """The tensors' last axis zero-padded to `width` (as they are when it
    is already that wide)."""
    return [t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))
            for t in tensors]


class _FusedAttention(torch.autograd.Function):
    """Forward saves q, k, v, out (padded to the kernel's head dim), the
    row statistics (max, normaliser), the mask and the seed; backward
    launches the dQ and dK/dV passes. `causal` picks the causal libraries
    (no seed) and their counters."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed, dropout_p, sm_scale, needs_grad,
                causal, heads):
        head_dim = q.shape[-1]
        q, k, v = _pad_heads(kernel_head_dim(head_dim), q, k, v)
        B, L, H, D = q.shape
        out = torch.empty_like(q)
        stats = (torch.empty((B, H, L, 2), dtype=torch.float32,
                             device=q.device) if needs_grad else None)
        tensors = (_build.DTYPE_CODE[q.dtype], _build.ptr(q), _build.ptr(k),
                   _build.ptr(v), _build.ptr(mask), _build.ptr(out),
                   _build.ptr(stats))
        if causal:
            lib = load_causal_kernel()
            err = lib.tr_causal_attention_fwd(*tensors, B, L, H, D, sm_scale,
                                              _build.stream())
            _build.check(lib, err, "causal_attention")
        else:
            lib = load_kernel()
            err = lib.tr_attention_fwd(
                *tensors, *_build.dropout_args(seed, dropout_p), *heads,
                B, L, H, D, sm_scale, _build.stream())
            _build.check(lib, err, "fused_dropout_attention")
        _count(D != head_dim, causal, bwd=False)
        ctx.save_for_backward(q, k, v, out, stats, mask, seed)
        ctx.dropout_p, ctx.sm_scale, ctx.causal = dropout_p, sm_scale, causal
        ctx.heads, ctx.head_dim = heads, head_dim
        return out if D == head_dim else out[..., :head_dim].contiguous()

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, stats, mask, seed = ctx.saved_tensors
        B, L, H, D = q.shape
        dout, = _pad_heads(D, dout.contiguous())
        if dout.data_ptr() % 16 != 0:
            dout = dout.clone()
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        delta = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
        inputs = (_build.DTYPE_CODE[q.dtype], _build.ptr(q), _build.ptr(k),
                  _build.ptr(v), _build.ptr(out), _build.ptr(dout),
                  _build.ptr(mask), _build.ptr(stats))
        outputs = (_build.ptr(dq), _build.ptr(dk), _build.ptr(dv),
                   _build.ptr(delta))
        shape = (B, L, H, D, ctx.sm_scale, _build.stream())
        if ctx.causal:
            lib = load_causal_bwd_kernel()
            err = lib.tr_causal_attention_bwd(*inputs, *outputs, *shape)
            _build.check(lib, err, "causal_attention backward")
        else:
            # the tensor-core dQ pass leaves its dropout bits here for the
            # dK/dV pass: two words of 32 keys per (key tile of 64, query)
            keep_words = None
            if seed is not None and q.dtype == torch.bfloat16:
                keep_words = torch.empty((B, H, L // 64, L, 2),
                                         dtype=torch.int32, device=q.device)
            lib = load_bwd_kernel()
            err = lib.tr_attention_bwd(
                *inputs, *_build.dropout_args(seed, ctx.dropout_p),
                *ctx.heads, *outputs, _build.ptr(keep_words), *shape)
            _build.check(lib, err, "fused_dropout_attention backward")
        _count(D != ctx.head_dim, ctx.causal, bwd=True)
        if D != ctx.head_dim:
            dq, dk, dv = (t[..., :ctx.head_dim] for t in (dq, dk, dv))
        return dq, dk, dv, None, None, None, None, None, None, None
