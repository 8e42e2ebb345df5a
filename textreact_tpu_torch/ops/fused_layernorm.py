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

Widths: every multiple of 128 up to 8192 (`MAX_HIDDEN`). Up to 1024
(`REGISTER_HIDDEN`) a warp holds a row; above, a block of 256 threads does
(the wide route, `WIDE_LAUNCHES` and `WIDE_BWD_LAUNCHES`).

Launches: one kernel a forward and one a backward. The backward's grid is
the blocks the card holds at once (`grid_blocks`, from the library's
occupancy plan); its blocks' dscale / dbias rows are summed in the same
launch by the last `split_blocks` blocks to finish, which count finished
blocks on two int32 counters that the wrapper keeps zeroed, one pair per
device and stream (`_counters`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build

# every multiple of 128 up to 1024 gives a row to a warp (the register
# route: the width a constant of its kernels); above, up to MAX_HIDDEN, to a
# block
REGISTER_HIDDEN = tuple(range(128, 1025, 128))
MAX_HIDDEN = 8192
MAX_SPLIT = 128   # blocks that sum the backward's column sums, at most
LAUNCHES = 0      # forward kernel launches since the last reset
BWD_LAUNCHES = 0  # backward launches (one kernel a call)
WIDE_LAUNCHES = 0      # the same two counts for the wide route
WIDE_BWD_LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_U = ctypes.c_uint32
_F = ctypes.c_float
_SIGNATURES = {
    "tr_residual_layernorm_bwd_plan": [_I, _I, _I, _P],
    "tr_residual_layernorm_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _U, _F,
                                  _L, _I, _F, _P],
    "tr_residual_layernorm_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _P, _P, _U, _F, _L, _I, _P],
    "tr_row_keep_mask": [_P, _U, _P, _L, _I, _P],
}


def takes_hidden(H: int) -> bool:
    """Whether the kernels take rows of H elements."""
    return H % 128 == 0 and 0 < H <= MAX_HIDDEN


def load_kernel():
    """Build (at first use) and load the kernels' library."""
    return _build.load("fused_layernorm", _SIGNATURES)


class Plan(NamedTuple):
    """The backward kernel's launch on one card
    (tr_residual_layernorm_bwd_plan)."""
    rows_per_block: int  # rows a block holds at once
    blocks_per_sm: int   # blocks an SM holds at once (occupancy)
    sms: int             # the card's SMs


def grid_blocks(rows: int, plan: Plan) -> int:
    """The backward's blocks: as many as the card holds at once, fewer when
    the rows do not fill them, at least one (a backward of no rows still
    writes dscale and dbias)."""
    return max(1, min(-(-rows // plan.rows_per_block),
                      plan.blocks_per_sm * plan.sms))


def split_blocks(nblocks: int, hidden: int) -> int:
    """How many of the backward's blocks sum the (nblocks, 2, hidden)
    workspace's columns, each a slice of them over every row: at most half
    the grid (a block that waits for the others never holds a place that a
    block yet to start needs), at least four float4 columns a block, at
    most MAX_SPLIT."""
    return max(1, min(nblocks // 2, 2 * hidden // 16, MAX_SPLIT))


_PLANS: dict = {}
_COUNTERS: dict = {}


def _plan(x: torch.Tensor, drop: bool) -> Plan:
    """The backward kernel's plan on x's card, asked of the library once a
    process."""
    key = (x.device.index, x.dtype, x.shape[-1], drop)
    plan = _PLANS.get(key)
    if plan is None:
        lib = load_kernel()
        out = (ctypes.c_int * 2)()
        err = lib.tr_residual_layernorm_bwd_plan(
            _build.DTYPE_CODE[x.dtype], x.shape[-1], int(drop), out)
        _build.check(lib, err, "fused_residual_layernorm plan")
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        plan = _PLANS[key] = Plan(*out, sms)
    return plan


def _counters(device: torch.device) -> torch.Tensor:
    """The two zeroed int32 counters of the current stream on `device`;
    every backward leaves them zeroed."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None:
        buf = _COUNTERS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return buf


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
    if not takes_hidden(H):
        raise ValueError(f"fused_residual_layernorm: hidden {H} is not a "
                         f"multiple of 128 up to {MAX_HIDDEN}")
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
    backward launches one kernel for dx, dy, dscale and dbias."""

    @staticmethod
    def forward(ctx, x, y, scale, bias, seed, eps, dropout_p, needs_grad):
        global LAUNCHES, WIDE_LAUNCHES
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
        if H in REGISTER_HIDDEN:
            LAUNCHES += 1
        else:
            WIDE_LAUNCHES += 1
        ctx.save_for_backward(x, y, scale, mean, rstd, seed)
        ctx.dropout_p = dropout_p
        return out

    @staticmethod
    def backward(ctx, g):
        global BWD_LAUNCHES, WIDE_BWD_LAUNCHES
        x, y, scale, mean, rstd, seed = ctx.saved_tensors
        H = x.shape[-1]
        rows = x.numel() // H
        g = g.contiguous()
        dx, dy = torch.empty_like(x), torch.empty_like(x)
        nblocks = grid_blocks(rows, _plan(x, seed is not None))
        ws = torch.empty((nblocks, 2, H), dtype=torch.float32,
                         device=x.device)
        dparams = torch.empty((2, H), dtype=torch.float32, device=x.device)
        lib = load_kernel()
        err = lib.tr_residual_layernorm_bwd(
            _build.DTYPE_CODE[x.dtype], _build.ptr(x), _build.ptr(y),
            _build.ptr(g), _build.ptr(scale), _build.ptr(mean),
            _build.ptr(rstd), _build.ptr(dx), _build.ptr(dy), _build.ptr(ws),
            _build.ptr(_counters(x.device)), nblocks,
            split_blocks(nblocks, H), _build.ptr(dparams),
            *_build.dropout_args(seed, ctx.dropout_p), rows, H,
            _build.stream())
        _build.check(lib, err, "fused_residual_layernorm backward")
        if H in REGISTER_HIDDEN:
            BWD_LAUNCHES += 1
        else:
            WIDE_BWD_LAUNCHES += 1
        return dx, dy, dparams[0], dparams[1], None, None, None, None
