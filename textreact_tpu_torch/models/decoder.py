"""Transformer decoder with causal self-attention and cross-attention
(twin of textreact_tpu/models/decoder.py), plus its decode cache.

LM logits come from a BERT-style prediction head tied to the decoder's own
word-embedding table.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from .config import TransformerConfig
from .layers import (Embeddings, MLMHead, Position, TransformerBlock,
                     causal_bias, mask_to_bias, remat_block)


@dataclasses.dataclass
class DecodeCache:
    """Per-layer decode state.

    self_k/self_v: the self-attention caches, written in place one
    position per step and never moved. With beam_groups = G > 0 they are
    the row-stable grouped beam cache (examples, H, D, cache_len * G),
    read under an ancestry bias (layers.py decode_self_grouped); with 0,
    one row per decode row (rows, H, cache_len, D). H is this rank's
    heads. cross_k/cross_v: (examples, H, L, D), projected once from the
    encoder states and never replicated across beams. cross_bias:
    (examples, 1, 1, L) f32 key-padding bias, or None.

    `Decoder.refill_cache` loads another batch of the same shapes into
    these tensors in place: a CUDA graph captured over the cache reads it
    where it lies, so no tensor of it is ever allocated again."""
    self_k: List[torch.Tensor]
    self_v: List[torch.Tensor]
    cross_k: List[torch.Tensor]
    cross_v: List[torch.Tensor]
    cross_bias: Optional[torch.Tensor]
    beam_groups: int = 0


def encoder_key_bias(encoder_attention_mask: Optional[torch.Tensor]
                     ) -> Optional[torch.Tensor]:
    """Cross-attention key bias; a 2-D bond mask keeps any valid row."""
    if encoder_attention_mask is None:
        return None
    enc_mask = encoder_attention_mask
    if enc_mask.dim() == 3:
        enc_mask = (enc_mask.sum(-1) > 0).to(torch.int32)
    return mask_to_bias(enc_mask)


class Decoder(nn.Module):
    def __init__(self, config: TransformerConfig,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.remat = remat   # teacher-forced pass only (decoder.py:65-66)
        # owned here so the LM head ties to it (decoder.py:57-63)
        self.word_embedding = nn.Parameter(
            torch.zeros(cfg.vocab_size, cfg.hidden_size, dtype=param_dtype))
        self.embeddings = Embeddings(cfg, dtype, own_word_embeddings=False,
                                     param_dtype=param_dtype)
        self.layers = nn.ModuleList(
            TransformerBlock(cfg, dtype, param_dtype)
            for _ in range(cfg.num_hidden_layers))
        self.lm_head = MLMHead(cfg, dtype, mlp=True, tied=True,
                               param_dtype=param_dtype)

    def forward(self, input_ids: torch.Tensor, encoder_states: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                encoder_attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced logits (B, L, V), f32. `generator` feeds the
        dropouts in training mode."""
        L = input_ids.shape[1]
        self_bias = causal_bias(L, L, device=input_ids.device)
        if attention_mask is not None:
            self_bias = self_bias + mask_to_bias(attention_mask)
        cross_bias = encoder_key_bias(encoder_attention_mask)
        x = self.embeddings(input_ids, word_embedding=self.word_embedding,
                            generator=generator)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = remat_block(layer, x, self_bias, encoder_states,
                                cross_bias, generator=generator)
            else:
                x = layer(x, self_bias, encoder_states, cross_bias,
                          generator=generator)
        return self.lm_head(x, embedding=self.word_embedding)

    def init_cache(self, encoder_states: torch.Tensor,
                   encoder_attention_mask: Optional[torch.Tensor],
                   rows: int, cache_len: int,
                   beam_groups: int = 0) -> DecodeCache:
        """Empty self-attention caches for `rows` decode rows, grouped by
        `beam_groups` beams an example when it is > 0, and the cross K/V
        from the trained projections of this decoder."""
        cfg = self.config
        # the heads of this rank (all of them without tensor parallelism)
        H, D = self.layers[0].attention.num_heads, cfg.head_dim
        if beam_groups:
            shape = (rows // beam_groups, H, D, cache_len * beam_groups)
        else:
            shape = (rows, H, cache_len, D)
        dev = encoder_states.device
        cross = [layer.crossattention.project_kv(encoder_states)
                 for layer in self.layers]
        return DecodeCache(
            self_k=[torch.zeros(shape, dtype=self.dtype, device=dev)
                    for _ in self.layers],
            self_v=[torch.zeros(shape, dtype=self.dtype, device=dev)
                    for _ in self.layers],
            cross_k=[k for k, _ in cross],
            cross_v=[v for _, v in cross],
            cross_bias=encoder_key_bias(encoder_attention_mask),
            beam_groups=beam_groups)

    def refill_cache(self, cache: DecodeCache, encoder_states: torch.Tensor,
                     encoder_attention_mask: Optional[torch.Tensor]) -> None:
        """Load a new batch into `cache` in place, as init_cache would make
        it for these arguments: the cross K/V and the key bias copied in,
        the self-attention caches zeroed. The shapes must be those the
        cache was made for."""
        for i, layer in enumerate(self.layers):
            k, v = layer.crossattention.project_kv(encoder_states)
            cache.cross_k[i].copy_(k)
            cache.cross_v[i].copy_(v)
        for t in cache.self_k + cache.self_v:
            t.zero_()
        bias = encoder_key_bias(encoder_attention_mask)
        if (bias is None) != (cache.cross_bias is None):
            raise ValueError("refill_cache: a key mask where the cache has "
                             "none, or none where it has one")
        if bias is not None:
            cache.cross_bias.copy_(bias)

    def decode(self, input_ids: torch.Tensor, cache: DecodeCache,
               position: Position,
               beam_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token per row at `position` (an int, or a 0-d int64 tensor
        on the cache's device): (rows, 1) ids -> (rows, 1, V)
        f32 logits; writes this position's K/V into the cache. A grouped
        cache needs the step's beam_bias (inference/beam.py::ancestor_bias),
        which serves every layer; a per-row cache takes none."""
        if (beam_bias is None) != (cache.beam_groups == 0):
            raise ValueError("beam_bias goes with a grouped cache "
                             f"(beam_groups {cache.beam_groups})")
        # computed on the device from a tensor position
        position_ids = (torch.arange(input_ids.shape[1],
                                     device=input_ids.device)[None, :]
                        + position)
        x = self.embeddings(input_ids, position_ids=position_ids,
                            word_embedding=self.word_embedding)
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, cache.self_k[i], cache.self_v[i], position,
                             cache.cross_k[i], cache.cross_v[i],
                             cache.cross_bias, beam_bias)
        return self.lm_head(x, embedding=self.word_embedding)
