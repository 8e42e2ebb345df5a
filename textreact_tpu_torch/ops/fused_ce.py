"""Linear + cross-entropy over a large vocabulary, folded together (twin of
textreact_tpu/ops/fused_ce.py; the MLM head's loss).

The (N, V) float32 logits are never held whole: the forward streams W in
vocab chunks through an online log-sum-exp (running max and sum), and the
backward recomputes each chunk's softmax while it accumulates dX, dW and db,
so autograd stores no per-chunk residual either. Semantics match
`losses.mlm_loss` / `F.cross_entropy(ignore_index=...)` summed: returns
(sum of the NLL over non-ignored rows, count of non-ignored rows).

In the JAX package this is plain JAX (`lax.scan` over chunks, no Pallas
kernel), so here the chunk products are `torch.matmul` and the loop is a
Python loop inside a `torch.autograd.Function`. Operands are cast to
`x.dtype` (bf16 in training) and the products accumulate in float32.
"""

from __future__ import annotations

from typing import Tuple

import torch

_NEG = -1e30  # bias of the pad columns of the last chunk


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 accumulation and a float32 result. For bf16
    operands the product runs in bf16 on the tensor cores (which accumulate
    in float32) with the result written directly as float32."""
    if a.dtype == torch.float32:
        return a @ b
    return torch.mm(a, b, out_dtype=torch.float32) if a.is_cuda else (
        a.float() @ b.float())


def _chunks(w: torch.Tensor, bias: torch.Tensor, vocab_axis: int, chunk: int,
            dtype: torch.dtype):
    """Yield (j, w_j (D, C) in `dtype`, b_j (C,) f32) over vocab chunks; the
    last chunk is padded with zero columns whose bias is -1e30."""
    if vocab_axis == 0:          # (V, D): tied word embedding
        w = w.t()
    v = w.shape[1]
    for j, start in enumerate(range(0, v, chunk)):
        w_j = w[:, start:start + chunk].to(dtype)
        b_j = bias[start:start + chunk].float()
        pad = chunk - w_j.shape[1]
        if pad:
            w_j = torch.nn.functional.pad(w_j, (0, pad))
            b_j = torch.nn.functional.pad(b_j, (0, pad), value=_NEG)
        yield j, w_j, b_j


class _FusedLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, bias, labels, ignore_id, vocab_axis, chunk):
        n = x.shape[0]
        valid = labels != ignore_id
        safe_labels = torch.where(valid, labels, 0).long()
        m = torch.full((n,), _NEG, dtype=torch.float32, device=x.device)
        s = torch.zeros(n, dtype=torch.float32, device=x.device)
        ll = torch.zeros(n, dtype=torch.float32, device=x.device)
        for j, w_j, b_j in _chunks(w, bias, vocab_axis, chunk, x.dtype):
            logits = _matmul_f32(x, w_j) + b_j
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(-1)
            m = m_new
            idx = safe_labels - j * chunk
            in_chunk = (idx >= 0) & (idx < chunk)
            picked = logits.gather(1, idx.clamp(0, chunk - 1)[:, None])[:, 0]
            ll = torch.where(in_chunk, picked, ll)
        lse = m + torch.log(s)
        sum_nll = torch.where(valid, lse - ll, 0.0).sum()
        n_valid = valid.sum().to(torch.int32)
        ctx.save_for_backward(x, w, bias, safe_labels, valid, lse)
        ctx.vocab_axis, ctx.chunk = vocab_axis, chunk
        ctx.mark_non_differentiable(n_valid)
        return sum_nll, n_valid

    @staticmethod
    def backward(ctx, g_sum, _g_valid):
        x, w, bias, safe_labels, valid, lse = ctx.saved_tensors
        vocab_axis, chunk = ctx.vocab_axis, ctx.chunk
        v = bias.shape[0]
        # per-row scale: g for valid rows, 0 for ignored ones
        gv = (g_sum * valid.float())[:, None]
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty((x.shape[1], v), dtype=torch.float32,
                         device=x.device)
        db = torch.empty(v, dtype=torch.float32, device=x.device)
        cols = torch.arange(chunk, device=x.device)[None, :]
        for j, w_j, b_j in _chunks(w, bias, vocab_axis, chunk, x.dtype):
            logits = _matmul_f32(x, w_j) + b_j
            p = torch.exp(logits - lse[:, None])
            idx = safe_labels - j * chunk
            in_chunk = (idx >= 0) & (idx < chunk)
            onehot = (cols == idx.clamp(0, chunk - 1)[:, None]) \
                & in_chunk[:, None]
            dlogits = (gv * (p - onehot.float())).to(x.dtype)
            dx += _matmul_f32(dlogits, w_j.t())
            start = j * chunk
            width = min(chunk, v - start)
            dw[:, start:start + width] = _matmul_f32(x.t(), dlogits)[:, :width]
            db[start:start + width] = dlogits.float().sum(0)[:width]
        if vocab_axis == 0:
            dw = dw.t()
        return (dx.to(x.dtype), dw.to(w.dtype), db.to(bias.dtype), None, None,
                None, None)


def fused_linear_ce(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    labels: torch.Tensor, ignore_id: int, vocab_axis: int = 1,
                    chunk: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of the NLL, and the count of valid rows, of softmax(x @ W + b)
    against labels.

    x: (N, D); w: (D, V) (vocab_axis=1, a dense kernel) or (V, D)
    (vocab_axis=0, a tied embedding); bias: (V,); labels: (N,) int with
    `ignore_id` holes. Returns (sum_nll float32 scalar, n_valid int32).
    Differentiable in x, w and bias."""
    return _FusedLinearCE.apply(x, w, bias, labels, ignore_id, vocab_axis,
                                chunk)
