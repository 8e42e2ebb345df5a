"""Residual add + LayerNorm (twin of textreact_tpu/ops/fused_layernorm.py).

`fused_residual_layernorm` computes LN(x + dropout(y)) over the last axis
with flax fast-variance numerics: f32 statistics, var = E[z^2] - E[z]^2
clamped at 0, eps inside the rsqrt, output in the input dtype.
`torch.nn.LayerNorm` takes the variance in two passes and is not a
substitute.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/fused_layernorm.cu, forward at p = 0) or raises; on a CPU tensor it
runs the plain version below.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

SUPPORTED_HIDDEN = (128, 256, 384, 512, 768, 1024)
LAUNCHES = 0  # kernel launches since the last reset

_P = ctypes.c_void_p
_SIGNATURES = {"tr_residual_layernorm_fwd": [
    ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int,
    ctypes.c_float, _P]}


def load_kernel():
    """Build (at first use) and load the kernel's library."""
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
                                 eps: float = 1e-12) -> torch.Tensor:
    """Plain version of the kernel (ops/fused_layernorm.py:254-263)."""
    return layer_norm(x.float() + y.float(), scale, bias, eps).to(x.dtype)


def fused_residual_layernorm(x: torch.Tensor, y: torch.Tensor,
                             scale: torch.Tensor, bias: torch.Tensor,
                             eps: float = 1e-12, dropout_p: float = 0.0,
                             generator: Optional[torch.Generator] = None
                             ) -> torch.Tensor:
    """LN(x + dropout(y, p)) over the last axis, in x's dtype."""
    if not x.is_cuda:
        if dropout_p > 0.0:
            keep = torch.rand(y.shape, generator=generator) >= dropout_p
            y = torch.where(keep, y.float() / (1.0 - dropout_p), 0.0)
        return residual_layernorm_reference(x, y, scale, bias, eps)
    return _launch(x, y, scale, bias, eps, dropout_p)


def _launch(x, y, scale, bias, eps, dropout_p):
    global LAUNCHES
    if dropout_p > 0.0:
        raise NotImplementedError(
            "fused_residual_layernorm kernel: dropout comes with training")
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad
                                    or scale.requires_grad):
        raise NotImplementedError(
            "fused_residual_layernorm kernel: no backward yet")
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
        if not t.is_contiguous():
            raise ValueError(f"fused_residual_layernorm: {name} not contiguous")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (H,):
            raise ValueError(f"fused_residual_layernorm: {name} must be "
                             f"float32 ({H},), got {t.dtype}{tuple(t.shape)}")
    out = torch.empty_like(x)
    lib = load_kernel()
    err = lib.tr_residual_layernorm_fwd(
        _build.DTYPE_CODE[x.dtype], _build.ptr(x), _build.ptr(y),
        _build.ptr(scale), _build.ptr(bias), _build.ptr(out),
        x.numel() // H, H, float(eps), _build.stream())
    _build.check(lib, err, "fused_residual_layernorm")
    LAUNCHES += 1
    return out
