"""Transformer encoder (twin of textreact_tpu/models/encoder.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import TransformerConfig
from .layers import (Embeddings, TransformerBlock, mask_to_bias,
                     remat_block)


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
        """`generator` feeds the dropouts in training mode."""
        x = self.embeddings(input_ids, position_ids=position_ids,
                            token_type_ids=token_type_ids,
                            generator=generator)
        bias = None
        self_mask = None
        if attention_mask is not None:
            if (self.config.attention_impl == "flash"
                    and attention_mask.dim() == 2):
                self_mask = attention_mask  # the fused path takes the raw mask
            else:
                bias = mask_to_bias(attention_mask)
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
