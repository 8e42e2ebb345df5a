"""Transformer building blocks (twin of textreact_tpu/models/layers.py).

Numerics follow the JAX package: every layer casts its matmul weights to
the compute dtype (bfloat16 or float32) at use, layer-norm parameters stay
float32; attention scores and softmax run in float32, the probabilities
meet v in the compute dtype with float32 accumulation; LayerNorm is flax
fast-variance in float32. Parameter names mirror the flax tree
(`convert.py` maps one onto the other).

Parameters are stored in `param_dtype`: float32 for training, as in the JAX
package, so the optimizer updates float32 values and each gradient lands on
them through the cast; or already in the compute dtype for serving, where
the cast is a no-op. One code path serves both.

Training mode (`module.train()`, flax's `deterministic=False`) turns the
dropouts on: after the embedding LayerNorm, on the attention probabilities
(inside the fused kernel on the fused path), and on each block's residual
branch (inside the fused LayerNorm kernel on the fused path). The masks
come from the `torch.Generator` passed to `forward`, never from the global
generator.

Decoding keeps the cross K/V projected once per example, unreplicated
across beams: beams attend as grouped query rows over their example's
encoder states. Beam search keeps its self-attention cache row-stable in
the grouped layout (Bex, H, D, T*G) (`decode_self_grouped`, the twin of
layers.py:232-309): beams never move it, and each beam reads its history
under an ancestry bias; on the card one kernel computes that attention
(ops/decode_attention.py). The per-row cache (`decode_self`) is the twin of
the JAX package's beam_groups=0 path. The decode products take the
compute-dtype operands in place, with the JAX package's output dtypes
(`_decode_bmm`).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..data.collate import IGNORE_INDEX
from ..ops.decode_attention import (_decode_bmm, grouped_decode_attention,
                                    grouped_decode_attention_reference)
from ..ops.fused_attention import (SEQ_MULTIPLE, PackedMask,
                                   causal_attention, fused_dropout_attention,
                                   masked_attention, pack_mask_bits,
                                   takes_packed_mask)
from ..ops.fused_ce import fused_linear_ce
from ..ops.fused_layernorm import (fused_residual_layernorm, layer_norm,
                                   residual_layernorm_reference)
from ..utils.profiling import span
from .config import TransformerConfig

NEG_INF = -1e9
# full-sequence attention calls that took the plain path under a bias made
# from a (B, Lq, Lk) mask (`mask_3d`: the template model's bond mask), where
# `mask_3d_route` did not hold; on the
# graphed routes the counter is kept at the replays (ops/launches.py), as
# the kernel wrappers' launch counters are
PLAIN_MASK_3D_CALLS = 0
# a decode position: a Python int, or a 0-d int64 tensor on the cache's
# device (beam search keeps it there, so that no step waits for the host)
Position = Union[int, torch.Tensor]


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, L) or (B, Lq, Lk) {0,1} mask -> (B, 1, Lq|1, Lk) f32 additive bias."""
    if mask.dim() == 2:
        bias = mask[:, None, None, :]
    elif mask.dim() == 3:
        bias = mask[:, None, :, :]
    else:
        raise ValueError(f"mask ndim {mask.dim()}")
    return (1.0 - bias.float()) * NEG_INF


def mask_3d_route(attention_impl: str, mask_rank: int, length: int,
                  dtype: torch.dtype, device: torch.device,
                  head_dim: int) -> bool:
    """Whether an encoder's self-attention over `length` positions of
    `dtype` on `device` takes a mask of rank `mask_rank` through the fused
    kernels as packed bits (ops/fused_attention.py::masked_attention):
    attention_impl 'flash', a (B, L, L) mask, a length that is a multiple
    of SEQ_MULTIPLE, and the kernels' own conditions
    (`fused_attention.takes_packed_mask`: bfloat16 on a CUDA device, a head
    dim they hold). Elsewhere the plain path takes it as a bias."""
    return (attention_impl == "flash" and mask_rank == 3
            and length % SEQ_MULTIPLE == 0
            and takes_packed_mask(dtype, device, head_dim))


def self_attention_mask(config: TransformerConfig,
                        mask: Optional[torch.Tensor], x: torch.Tensor):
    """(mask_kv, bias) for the self-attention of every layer of an encoder
    over `x` (B, L, hidden) under `mask`, a (B, L) key mask or a (B, L, L)
    admission mask: under 'flash' a key mask goes to the fused kernels as
    it is, a (B, L, L) mask packed once (a `PackedMask`) where
    `mask_3d_route` holds; any other mask becomes the plain path's bias."""
    if mask is None:
        return None, None
    if config.attention_impl == "flash" and mask.dim() == 2:
        return mask, None
    if mask_3d_route(config.attention_impl, mask.dim(), x.shape[1], x.dtype,
                     x.device, config.head_dim):
        return pack_mask_bits(mask), None
    return None, mask_to_bias(mask)


def causal_bias(q_len: int, k_len: int, offset: int = 0,
                device=None) -> torch.Tensor:
    """(1, 1, q_len, k_len) f32 causal additive bias; offset shifts the
    query positions."""
    q_pos = torch.arange(q_len, device=device)[:, None] + offset
    k_pos = torch.arange(k_len, device=device)[None, :]
    bias = torch.where(k_pos <= q_pos, 0.0, NEG_INF).to(torch.float32)
    return bias[None, None]


def _slot(position: Position, device: torch.device) -> torch.Tensor:
    """The decode position as a (1,) int64 index on `device`: a tensor
    position is viewed where it lies, never read by the host (indexing or
    slicing at a 0-d tensor would wait for it)."""
    if isinstance(position, torch.Tensor):
        return position.view(1)
    return torch.full((1,), position, dtype=torch.long, device=device)


def dropout_uniforms(shape, generator: Optional[torch.Generator],
                     device: torch.device) -> torch.Tensor:
    """`dropout`'s draw: one float32 `torch.rand` of `shape` from
    `generator`; an element is kept where its uniform is at least p. The
    fused route under a packed 3-D mask makes the same draw at the same
    point of the generator's sequence and hands it to the kernels as
    bits."""
    return torch.rand(shape, generator=generator, device=device)


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator],
            head_offset: int = 0, total_heads: Optional[int] = None
            ) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - p and rescale.

    For (B, H, Lq, Lk) attention weights of heads head_offset .. + H of a
    layer with `total_heads` (a tp rank's heads), the mask is drawn for
    every head and this rank's heads are cut from it, so that the ranks'
    heads carry the masks of the unsharded layer."""
    if p <= 0.0:
        return x
    shape = x.shape
    if total_heads is not None and total_heads != shape[1]:
        shape = (shape[0], total_heads) + tuple(shape[2:])
    keep = dropout_uniforms(shape, generator, x.device) >= p
    if shape != x.shape:
        keep = keep[:, head_offset:head_offset + x.shape[1]]
    return torch.where(keep, x / (1.0 - p), 0.0)


class Linear(nn.Linear):
    """flax nn.Dense(dtype=compute dtype): input, weight and bias are cast
    to the compute dtype at use; the parameters keep their own dtype.

    `tp_reduce` (set by parallel.sharding.shard_params on a row-split
    output layer) sums the tp ranks' partial products in float32 and adds
    the bias once, after the sum."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__(in_features, out_features, dtype=param_dtype)
        self.compute_dtype = dtype
        self.tp_reduce = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.tp_reduce is None:
            return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))
        y = self.tp_reduce.reduce(F.linear(x.to(dt), self.weight.to(dt)))
        return (y + self.bias.to(dt).float()).to(dt)


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm(dtype=float32): f32 params, f32 output."""

    def __init__(self, hidden: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden))
        self.bias = nn.Parameter(torch.zeros(hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Embeddings(nn.Module):
    """word + position + token-type embeddings with post-sum LayerNorm.

    With `own_word_embeddings=False` the word table is passed to forward
    (the decoder owns it and ties it to the LM head)."""

    def __init__(self, config: TransformerConfig, dtype: torch.dtype,
                 own_word_embeddings: bool = True,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        if own_word_embeddings:
            self.word_embeddings = nn.Embedding(
                cfg.vocab_size, cfg.hidden_size, dtype=param_dtype)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, dtype=param_dtype)
        if cfg.type_vocab_size > 0:
            self.token_type_embeddings = nn.Embedding(
                cfg.type_vocab_size, cfg.hidden_size, dtype=param_dtype)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                word_embedding: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)[None, :]
        if word_embedding is None:
            word_embedding = self.word_embeddings.weight
        # rows are gathered, then cast: the same values as casting the table
        # first (flax nn.Embed(dtype=...)) without a pass over the table
        dtype = self.dtype
        x = (F.embedding(input_ids, word_embedding).to(dtype)
             + self.position_embeddings(position_ids).to(dtype))
        if self.config.type_vocab_size > 0:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + self.token_type_embeddings(token_type_ids).to(dtype)
        x = self.layer_norm(x)
        if self.training:
            x = dropout(x, self.config.hidden_dropout_prob, generator)
        return x.to(dtype)


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention with f32 scores and softmax.

    `forward` is the full-sequence path; `decode_self_grouped` (beam
    search's), `decode_self` (per row) and `decode_cross` are the one-token
    decode paths over the caches in `DecodeCache`.

    `causal_hint` (layers.py:142, set by `TransformerBlock(causal=True)`)
    marks a decoder self-attention. Where the kernel's conditions hold
    (attention_impl 'flash', no bias, lengths that are multiples of 128) it
    takes the causal kernel, which applies no attention-probability dropout
    even in training mode, as layers.py:217-220 ignores drop_p on that
    branch. Elsewhere the plain path adds `causal_bias` exactly where the
    JAX package does (layers.py:225-230): only when a `mask_kv` is given.
    With `causal_hint` and neither mask nor bias, the plain path is NOT
    causal; that quirk of the reference is mirrored as it stands."""

    def __init__(self, config: TransformerConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype = torch.float32,
                 causal_hint: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.causal_hint = causal_hint
        H, D = cfg.num_attention_heads, cfg.head_dim
        self.query = Linear(cfg.hidden_size, H * D, dtype, param_dtype)
        self.key = Linear(cfg.hidden_size, H * D, dtype, param_dtype)
        self.value = Linear(cfg.hidden_size, H * D, dtype, param_dtype)
        self.output = Linear(H * D, cfg.hidden_size, dtype, param_dtype)
        # the heads this module computes: all of them, or under tensor
        # parallelism heads head_offset .. + num_heads of total_heads
        self.num_heads, self.head_offset, self.total_heads = H, 0, H
        self.tp = None

    def set_tensor_parallel(self, tp) -> None:
        """Compute heads tp.rank * H / tp.size onward (the projections'
        weights are cut by parallel.sharding.shard_params)."""
        self.tp = tp
        self.num_heads = self.total_heads // tp.size
        self.head_offset = tp.rank * self.num_heads
        self.output.tp_reduce = tp

    def _enter(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp is None else self.tp.enter(x)

    def _heads(self, y: torch.Tensor) -> torch.Tensor:
        return y.view(y.shape[0], y.shape[1], self.num_heads,
                      self.config.head_dim)

    def _out(self, ctx: torch.Tensor) -> torch.Tensor:
        ctx = ctx.to(self.dtype)
        return self.output(ctx.reshape(ctx.shape[0], ctx.shape[1], -1))

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                mask_kv: Optional[Union[torch.Tensor, PackedMask]] = None,
                generator: Optional[torch.Generator] = None,
                mask_3d: bool = False) -> torch.Tensor:
        """`mask_3d`: the call is under a (B, Lq, Lk) mask, given either as
        `bias` (the plain path, which counts such calls in
        PLAIN_MASK_3D_CALLS) or packed as `mask_kv` (a `PackedMask` from
        `self_attention_mask`: the fused kernels, inside the span
        `attention.mask_3d`). The plain path runs inside the span
        `attention.plain`."""
        cfg = self.config
        D = cfg.head_dim
        if isinstance(mask_kv, PackedMask) and (
                kv is not None or bias is not None or self.causal_hint):
            raise ValueError("a packed (B, L, L) mask is an encoder "
                             "self-attention's only mask")
        x = self._enter(x)
        kv_in = x if kv is None else self._enter(kv)
        drop_p = cfg.attention_probs_dropout_prob if self.training else 0.0
        q = self._heads(self.query(x))
        k = self._heads(self.key(kv_in))
        v = self._heads(self.value(kv_in))
        if isinstance(mask_kv, PackedMask):
            with span("attention.mask_3d"):
                # the plain path's draw, where the plain path makes it
                uniforms = None if drop_p <= 0.0 else dropout_uniforms(
                    (x.shape[0], self.total_heads, x.shape[1], x.shape[1]),
                    generator, x.device)
                ctx = masked_attention(q, k, v, mask_kv, drop_p, uniforms,
                                       sm_scale=1.0 / math.sqrt(D),
                                       head_offset=self.head_offset)
            return self._out(ctx)
        # the fused kernels want 128-aligned lengths and no extra bias
        # (layers.py:201-203); the decoder always carries a bias
        if (cfg.attention_impl == "flash" and bias is None
                and x.shape[1] % SEQ_MULTIPLE == 0
                and kv_in.shape[1] % SEQ_MULTIPLE == 0):
            if self.causal_hint:   # no dropout here (layers.py:217-220)
                return self._out(causal_attention(
                    q, k, v, mask_kv, sm_scale=1.0 / math.sqrt(D)))
            return self._out(fused_dropout_attention(
                q, k, v, mask_kv, drop_p, generator,
                sm_scale=1.0 / math.sqrt(D), head_offset=self.head_offset,
                total_heads=self.total_heads))
        if mask_3d:
            global PLAIN_MASK_3D_CALLS
            PLAIN_MASK_3D_CALLS += 1
        with span("attention.plain"):
            if mask_kv is not None:
                extra = mask_to_bias(mask_kv)
                bias = extra if bias is None else bias + extra
                if self.causal_hint:   # only under a mask_kv (layers.py:229)
                    bias = bias + causal_bias(x.shape[1], kv_in.shape[1],
                                              device=x.device)
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                             k.float()) / math.sqrt(D)
            if bias is not None:
                s = s + bias.float()
            probs = dropout(torch.softmax(s, dim=-1), drop_p, generator,
                            self.head_offset, self.total_heads)
            ctx = torch.einsum("bhqk,bkhd->bqhd",
                               probs.to(self.dtype).float(), v.float())
        return self._out(ctx)

    def project_kv(self, src: torch.Tensor):
        """Cross K/V of the encoder states, head-major (B, H, L, D)."""
        k = self._heads(self.key(src)).transpose(1, 2).contiguous()
        v = self._heads(self.value(src)).transpose(1, 2).contiguous()
        return k, v

    def decode_cross(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (Bk*G, 1, d) with G beams per example; k, v: (Bk, H, L, D),
        read in place; bias: (Bk, 1, 1, L). Beams attend as G query rows of
        their example (layers.py:162-194): f32 scores, the context
        accumulated in f32 and rounded to the compute dtype."""
        with span("decode.cross_attention"):
            H, D = self.num_heads, self.config.head_dim
            Bk, L = k.shape[0], k.shape[2]
            G = x.shape[0] // Bk
            q = self.query(x).view(Bk, G, H, D).transpose(1, 2).reshape(
                Bk * H, G, D)
            s = _decode_bmm(q, k.view(Bk * H, L, D).transpose(1, 2),
                            torch.float32).view(Bk, H, G, L) / math.sqrt(D)
            if bias is not None:
                s = s + bias.float()
            probs = torch.softmax(s, dim=-1).to(self.dtype)
            ctx = _decode_bmm(probs.view(Bk * H, G, L),
                              v.view(Bk * H, L, D), self.dtype)  # (Bk*H, G, D)
            return self._out(ctx.view(Bk, H, G, D).transpose(1, 2).reshape(
                Bk * G, 1, H * D))

    def decode_self(self, x: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, position: Position) -> torch.Tensor:
        """One token per row, the twin of the JAX package's beam_groups=0
        path (layers.py:310-352). x: (N, 1, d); cache_k/v: (N, H, T, D),
        head first so that the prefix is read in place, written at
        `position`; attends over positions 0..position with f32 scores.
        At an int position the prefix 0..position is read; at a 0-d
        tensor position, which no slice may take as a bound without a
        host wait, all T slots are read under the JAX package's bias that
        masks those past the position."""
        with span("decode.self_attention"):
            H, D = self.num_heads, self.config.head_dim
            N = x.shape[0]
            at = _slot(position, cache_k.device)
            cache_k.index_copy_(2, at, self.key(x).view(N, H, 1, D))
            cache_v.index_copy_(2, at, self.value(x).view(N, H, 1, D))
            q = self.query(x).view(N * H, 1, D)
            bias = None
            if isinstance(position, int):
                t = position + 1
            else:
                t = cache_k.shape[2]
                bias = torch.where(
                    torch.arange(t, device=x.device) <= position, 0.0,
                    NEG_INF)
            k = cache_k[:, :, :t].view(N * H, t, D)    # views: no copy
            v = cache_v[:, :, :t].view(N * H, t, D)
            s = _decode_bmm(q, k.transpose(1, 2), torch.float32) / math.sqrt(D)
            if bias is not None:
                s = s + bias
            probs = torch.softmax(s, dim=-1).to(self.dtype)
            ctx = _decode_bmm(probs, v, self.dtype)               # (N*H, 1, D)
            return self._out(ctx.view(N, 1, H * D))

    def decode_self_grouped(self, x: torch.Tensor, cache_k: torch.Tensor,
                            cache_v: torch.Tensor, position: Position,
                            beam_bias: torch.Tensor) -> torch.Tensor:
        """The row-stable grouped beam decode (layers.py:232-309). x:
        (Bex*G, 1, d), G beams per example; cache_k/v: (Bex, H, D, T*G),
        head first and the merged (t, g) axis last, written in place at
        [..., position*G : (position+1)*G] (only the new token is
        transposed; `position` an int or a 0-d int64 tensor on the
        cache's device, which beam search's device-state loop passes);
        beam_bias: (Bex, G, W*G) f32 from
        inference/beam.py::ancestor_bias, whose width carries the step's
        window W: the attention reads the cache prefix [..., :W*G] in place
        and each beam sees one row per valid position, its ancestor's.
        Scores are stored in the compute dtype unless decode_scores_dtype
        is 'float32'; then scaled, biased and softmaxed in f32. On the card
        one kernel computes the attention (ops/decode_attention.py), on the
        CPU its plain version."""
        with span("decode.self_attention"):
            cfg = self.config
            H, D = self.num_heads, cfg.head_dim
            Bex = cache_k.shape[0]
            G = x.shape[0] // Bex
            # (Bex*G, 1, H*D) -> (Bex, H, D, 1, G): the new token alone is
            # transposed; the cache, seen as (Bex, H, D, T, G), is written
            # where it lies at the position's G slots
            at, T = _slot(position, cache_k.device), cache_k.shape[-1] // G
            cache_k.view(Bex, H, D, T, G).index_copy_(3, at, self.key(x).view(
                Bex, G, H, D).permute(0, 2, 3, 1)[:, :, :, None])
            cache_v.view(Bex, H, D, T, G).index_copy_(3, at, self.value(
                x).view(Bex, G, H, D).permute(0, 2, 3, 1)[:, :, :, None])
            q = self.query(x).view(Bex, G, H, D).transpose(1, 2).reshape(
                Bex * H, G, D)
            attend = (grouped_decode_attention if q.is_cuda
                      else grouped_decode_attention_reference)
            ctx = attend(q, cache_k, cache_v, beam_bias, 1.0 / math.sqrt(D),
                         cfg.decode_scores_dtype != "float32")  # (Bex*H, G, D)
            return self._out(ctx.view(Bex, H, G, D).transpose(1, 2).reshape(
                Bex * G, 1, H * D))


class ResidualLayerNorm(nn.Module):
    """LayerNorm(x + dropout(res)) with nn.LayerNorm's param names. The
    fused kernel runs when layernorm_impl == 'fused' and the hidden size is
    a multiple of 128 (layers.py:374) and draws the residual dropout
    itself; otherwise a plain dropout goes before the plain version
    (layers.py:425-434)."""

    def __init__(self, config: TransformerConfig, dtype: torch.dtype):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(config.hidden_size))
        self.bias = nn.Parameter(torch.zeros(config.hidden_size))

    def forward(self, x: torch.Tensor, res: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        drop_p = cfg.hidden_dropout_prob if self.training else 0.0
        if cfg.layernorm_impl == "fused" and cfg.hidden_size % 128 == 0:
            return fused_residual_layernorm(
                x.to(self.dtype), res.to(self.dtype), self.weight, self.bias,
                cfg.layer_norm_eps, drop_p, generator)
        res = dropout(res, drop_p, generator)
        return residual_layernorm_reference(
            x, res, self.weight, self.bias, cfg.layer_norm_eps).to(self.dtype)


class FeedForward(nn.Module):
    def __init__(self, config: TransformerConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.intermediate = Linear(config.hidden_size,
                                   config.intermediate_size, dtype,
                                   param_dtype)
        self.output = Linear(config.intermediate_size, config.hidden_size,
                             dtype, param_dtype)
        self.tp = None

    def set_tensor_parallel(self, tp) -> None:
        """Compute intermediate columns of this tp rank (the weights are cut
        by parallel.sharding.shard_params)."""
        self.tp = tp
        self.output.tp_reduce = tp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = self.tp.enter(x)
        h = self.intermediate(x)
        if self.config.hidden_act == "gelu":
            h = F.gelu(h, approximate="tanh")   # flax nn.gelu default
        else:
            h = getattr(F, self.config.hidden_act)(h)
        return self.output(h)


class TransformerBlock(nn.Module):
    """Post-LN block: self-attn, cross-attn (decoder), ffn, each followed
    by a residual LayerNorm. `causal` (layers.py:408) makes the
    self-attention causal through `MultiHeadAttention(causal_hint=True)`."""

    def __init__(self, config: TransformerConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype = torch.float32,
                 causal: bool = False):
        super().__init__()
        self.config = config
        self.attention = MultiHeadAttention(config, dtype, param_dtype,
                                            causal_hint=causal)
        self.attention_norm = ResidualLayerNorm(config, dtype)
        if config.add_cross_attention:
            self.crossattention = MultiHeadAttention(config, dtype,
                                                     param_dtype)
            self.crossattention_norm = ResidualLayerNorm(config, dtype)
        self.ffn = FeedForward(config, dtype, param_dtype)
        self.ffn_norm = ResidualLayerNorm(config, dtype)

    def forward(self, x: torch.Tensor, self_bias: Optional[torch.Tensor] = None,
                encoder_states: Optional[torch.Tensor] = None,
                cross_bias: Optional[torch.Tensor] = None,
                self_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                mask_3d: bool = False) -> torch.Tensor:
        """`mask_3d`: the self-attention is under a (B, L, L) mask, as
        `self_bias` or packed as `self_mask`."""
        x = self.attention_norm(
            x, self.attention(x, bias=self_bias, mask_kv=self_mask,
                              generator=generator, mask_3d=mask_3d),
            generator)
        if self.config.add_cross_attention and encoder_states is not None:
            x = self.crossattention_norm(
                x, self.crossattention(x, kv=encoder_states, bias=cross_bias,
                                       generator=generator), generator)
        return self.ffn_norm(x, self.ffn(x), generator)

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, position: Position,
               cross_k: torch.Tensor, cross_v: torch.Tensor,
               cross_bias: Optional[torch.Tensor],
               beam_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decode step; a beam_bias selects the grouped self-attention
        cache, none the per-row one."""
        if beam_bias is None:
            res = self.attention.decode_self(x, cache_k, cache_v, position)
        else:
            res = self.attention.decode_self_grouped(x, cache_k, cache_v,
                                                     position, beam_bias)
        x = self.attention_norm(x, res)
        x = self.crossattention_norm(
            x, self.crossattention.decode_cross(x, cross_k, cross_v,
                                                cross_bias))
        return self.ffn_norm(x, self.ffn(x))


def remat_block(layer: TransformerBlock, *args,
                generator: Optional[torch.Generator] = None,
                **kwargs) -> torch.Tensor:
    """`layer(*args, generator=generator, **kwargs)` with its activations
    recomputed in the backward (`torch.utils.checkpoint`; flax `nn.remat`,
    encoder.py:45-46).

    `torch.utils.checkpoint` preserves the global generator only, and the
    port's dropouts and kernel seeds come from an explicit one: the
    recomputation is therefore run with `generator` put back into the state
    it had before the first pass (and returned to where it was afterwards),
    so it draws the same masks. Without that the gradients would be wrong
    and nothing would say so."""
    state = None if generator is None else generator.get_state()
    first_pass = [True]

    def run(*a, **k):
        if first_pass[0] or generator is None:
            first_pass[0] = False
            return layer(*a, generator=generator, **k)
        now = generator.get_state()
        generator.set_state(state)
        try:
            return layer(*a, generator=generator, **k)
        finally:
            generator.set_state(now)

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)


class MLMHead(nn.Module):
    """BERT prediction head: [dense + gelu + LN] then the vocab projection,
    tied to a given embedding table when `tied`. With `labels` it returns
    (sum of NLL, count of valid labels) through the chunked linear + CE
    (ops/fused_ce.py) instead of the (B, P, V) f32 logits."""

    def __init__(self, config: TransformerConfig, dtype: torch.dtype,
                 mlp: bool = True, tied: bool = False,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.dtype = dtype
        self.mlp = mlp
        if mlp:
            self.transform = Linear(cfg.hidden_size, cfg.hidden_size, dtype,
                                    param_dtype)
            self.transform_norm = LayerNorm(cfg.hidden_size,
                                            cfg.layer_norm_eps)
        if tied:
            self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        else:
            # nn.Dense(dtype=float32): the input is promoted to f32
            self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size)

    def forward(self, x: torch.Tensor,
                embedding: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None):
        if self.mlp:
            x = F.gelu(self.transform(x), approximate="tanh")
            x = self.transform_norm(x).to(self.dtype)
        d = x.shape[-1]
        if embedding is not None:
            if labels is not None:
                return fused_linear_ce(x.reshape(-1, d), embedding, self.bias,
                                       labels.reshape(-1), IGNORE_INDEX, 0)
            return F.linear(x.float(),
                            embedding.to(self.dtype).float()) + self.bias
        if labels is not None:
            return fused_linear_ce(x.reshape(-1, d), self.decoder.weight.t(),
                                   self.decoder.bias, labels.reshape(-1),
                                   IGNORE_INDEX, 1)
        return self.decoder(x.float())
