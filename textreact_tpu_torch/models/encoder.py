"""Transformer encoder (twin of textreact_tpu/models/encoder.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import TransformerConfig
from .layers import (Embeddings, TransformerBlock, remat_block,
                     self_attention_mask)


class Encoder(nn.Module):
    def __init__(self, config: TransformerConfig,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        """`remat`: in training, recompute each block's activations in the
        backward instead of keeping them (encoder.py:45-46)."""
        super().__init__()
        self.config = config
        self.remat = remat
        self.embeddings = Embeddings(config, dtype, param_dtype=param_dtype)
        self.layers = nn.ModuleList(
            TransformerBlock(config, dtype, param_dtype)
            for _ in range(config.num_hidden_layers))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` feeds the dropouts in training mode. A (B, L, L)
        mask is packed once for every layer where the fused kernels take
        it (`self_attention_mask`), else made into the plain path's
        bias."""
        x = self.embeddings(input_ids, position_ids=position_ids,
                            token_type_ids=token_type_ids,
                            generator=generator)
        self_mask, bias = self_attention_mask(self.config, attention_mask, x)
        mask_3d = attention_mask is not None and attention_mask.dim() == 3
        remat = self.remat and self.training and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = remat_block(layer, x, self_bias=bias, self_mask=self_mask,
                                generator=generator, mask_3d=mask_3d)
            else:
                x = layer(x, self_bias=bias, self_mask=self_mask,
                          generator=generator, mask_3d=mask_3d)
        return x
