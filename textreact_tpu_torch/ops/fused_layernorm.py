"""Residual add + LayerNorm (twin of textreact_tpu/ops/fused_layernorm.py).

`fused_residual_layernorm` computes LN(x + dropout(y)) over the last axis
with flax fast-variance numerics: f32 statistics, var = E[z^2] - E[z]^2
clamped at 0, eps inside the rsqrt, output in the input dtype.
`torch.nn.LayerNorm` takes the variance in two passes and is not a
substitute.

On a CUDA tensor the wrapper launches the hand-written kernels
(csrc/fused_layernorm.cu: forward, and a backward behind a
`torch.autograd.Function`) or raises; on a CPU tensor it runs the plain
version below under ordinary autograd. Dropout bits come from the
counter-based generator in csrc/philox.cuh, keyed by one seed per call that
is drawn from the caller's `torch.Generator`; the backward regenerates the
mask and recomputes z, so neither is stored. `keep_mask` exports the mask
for tests.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

# every multiple of 128 up to 1024, where a lane's backward fills the
# register file (TR_HIDDEN_CASES in the .cu)
SUPPORTED_HIDDEN = tuple(range(128, 1025, 128))
BWD_MAX_BLOCKS = 512  # backward grid cap: rows of the dscale/dbias workspace
BWD_WARPS = 4         # rows in flight per backward block (kWarps in the .cu)
LAUNCHES = 0      # forward kernel launches since the last reset
BWD_LAUNCHES = 0  # backward launches (row kernel + column sums)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_U = ctypes.c_uint32
_F = ctypes.c_float
_SIGNATURES = {
    "tr_residual_layernorm_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _U, _F,
                                  _L, _I, _F, _P],
    "tr_residual_layernorm_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _P, _P, _U, _F, _L, _I, _P],
    "tr_row_keep_mask": [_P, _U, _P, _L, _I, _P],
}


def load_kernel():
    """Build (at first use) and load the kernels' library."""
    return _build.load("fused_layernorm", _SIGNATURES)


def layer_norm(z: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """flax fast-variance LayerNorm over the last axis, in f32; returns f32.
    Also the module-level LayerNorm (nn.LayerNorm(dtype=float32) in flax)."""
    z = z.float()
    mean = z.mean(-1, keepdim=True)
    var = torch.clamp((z * z).mean(-1, keepdim=True) - mean * mean, min=0.0)
    xhat = (z - mean) * torch.rsqrt(var + eps)
    return xhat * scale.float() + bias.float()


def residual_layernorm_reference(x: torch.Tensor, y: torch.Tensor,
                                 scale: torch.Tensor, bias: torch.Tensor,
                                 eps: float = 1e-12,
                                 keep: Optional[torch.Tensor] = None,
                                 dropout_p: float = 0.0) -> torch.Tensor:
    """Plain version of the kernel (ops/fused_layernorm.py:51-82, 254-263).
    `keep`: optional bool dropout keep mask of y's shape."""
    y = y.float()
    if keep is not None:
        y = y * torch.where(keep, 1.0 / (1.0 - dropout_p), 0.0)
    return layer_norm(x.float() + y, scale, bias, eps).to(x.dtype)


def fused_residual_layernorm(x: torch.Tensor, y: torch.Tensor,
                             scale: torch.Tensor, bias: torch.Tensor,
                             eps: float = 1e-12, dropout_p: float = 0.0,
                             generator: Optional[torch.Generator] = None,
                             keep: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """LN(x + dropout(y, p)) over the last axis, in x's dtype.

    Differentiable in x, y, scale, bias. With dropout_p > 0 the mask comes
    from `generator` (its device must be the tensors'); `keep`, an explicit
    bool mask of y's shape, is for CPU tensors only."""
    if not x.is_cuda:
        if dropout_p > 0.0 and keep is None:
            keep = torch.rand(y.shape, generator=generator) >= dropout_p
        return residual_layernorm_reference(
            x, y, scale, bias, eps, keep if dropout_p > 0.0 else None,
            dropout_p)
    if keep is not None:
        raise ValueError("fused_residual_layernorm: the kernel draws its own "
                         "mask; keep= is for CPU tensors")
    _check(x, y, scale, bias)
    seed = _build.draw_seed(generator, x.device) if dropout_p > 0.0 else None
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, y, scale, bias))
    return _FusedResidualLayerNorm.apply(x, y, scale, bias, seed, float(eps),
                                         float(dropout_p), needs_grad)


def keep_mask(seed: torch.Tensor, rows: int, hidden: int,
              dropout_p: float) -> torch.Tensor:
    """The (rows, hidden) bool keep mask the kernels draw for `seed` (a (1,)
    int64 CUDA tensor), written by the library's test-only entry point."""
    out = torch.empty((rows, hidden), dtype=torch.uint8, device=seed.device)
    lib = load_kernel()
    err = lib.tr_row_keep_mask(_build.ptr(seed),
                               _build.dropout_threshold(dropout_p),
                               _build.ptr(out), rows, hidden, _build.stream())
    _build.check(lib, err, "layernorm keep mask")
    return out.bool()


def _check(x, y, scale, bias) -> None:
    """Validate the kernels' preconditions."""
    H = x.shape[-1]
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"fused_residual_layernorm: dtype {x.dtype}")
    if y.dtype != x.dtype or y.shape != x.shape:
        raise ValueError(f"x {x.dtype}{tuple(x.shape)} vs y "
                         f"{y.dtype}{tuple(y.shape)}")
    if H not in SUPPORTED_HIDDEN:
        raise ValueError(f"fused_residual_layernorm: hidden {H} not in "
                         f"{SUPPORTED_HIDDEN}")
    for name, t in (("x", x), ("y", y), ("scale", scale), ("bias", bias)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"fused_residual_layernorm: {name} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError(f"fused_residual_layernorm: {name} must be "
                             f"contiguous and 16-byte aligned")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (H,):
            raise ValueError(f"fused_residual_layernorm: {name} must be "
                             f"float32 ({H},), got {t.dtype}{tuple(t.shape)}")


class _FusedResidualLayerNorm(torch.autograd.Function):
    """Forward saves x, y, scale, the row mean and rstd and the seed;
    backward launches the row kernel and the column sums."""

    @staticmethod
    def forward(ctx, x, y, scale, bias, seed, eps, dropout_p, needs_grad):
        global LAUNCHES
        H = x.shape[-1]
        rows = x.numel() // H
        out = torch.empty_like(x)
        mean = rstd = None
        if needs_grad:
            mean = torch.empty(rows, dtype=torch.float32, device=x.device)
            rstd = torch.empty_like(mean)
        lib = load_kernel()
        err = lib.tr_residual_layernorm_fwd(
            _build.DTYPE_CODE[x.dtype], _build.ptr(x), _build.ptr(y),
            _build.ptr(scale), _build.ptr(bias), _build.ptr(out),
            _build.ptr(mean), _build.ptr(rstd),
            *_build.dropout_args(seed, dropout_p), rows, H, eps, _build.stream())
        _build.check(lib, err, "fused_residual_layernorm")
        LAUNCHES += 1
        ctx.save_for_backward(x, y, scale, mean, rstd, seed)
        ctx.dropout_p = dropout_p
        return out

    @staticmethod
    def backward(ctx, g):
        global BWD_LAUNCHES
        x, y, scale, mean, rstd, seed = ctx.saved_tensors
        H = x.shape[-1]
        rows = x.numel() // H
        g = g.contiguous()
        dx, dy = torch.empty_like(x), torch.empty_like(x)
        nblocks = max(1, min(-(-rows // BWD_WARPS), BWD_MAX_BLOCKS))
        partial = torch.empty((nblocks, 2, H), dtype=torch.float32,
                              device=x.device)
        dparams = torch.empty((2, H), dtype=torch.float32, device=x.device)
        lib = load_kernel()
        err = lib.tr_residual_layernorm_bwd(
            _build.DTYPE_CODE[x.dtype], _build.ptr(x), _build.ptr(y),
            _build.ptr(g), _build.ptr(scale), _build.ptr(mean),
            _build.ptr(rstd), _build.ptr(dx), _build.ptr(dy),
            _build.ptr(partial), nblocks, _build.ptr(dparams),
            *_build.dropout_args(seed, ctx.dropout_p), rows, H, _build.stream())
        _build.check(lib, err, "fused_residual_layernorm backward")
        BWD_LAUNCHES += 1
        return dx, dy, dparams[0], dparams[1], None, None, None, None
