"""Seq2seq encoder-decoder and its one-token decode step (twin of
textreact_tpu/models/encdec.py: EncoderDecoder, DecoderStep)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import TransformerConfig
from .decoder import DecodeCache, Decoder
from .encoder import Encoder
from .layers import MLMHead


class EncoderDecoder(nn.Module):
    """Seq2seq predictor (RCR conditions / template-free retro)."""

    def __init__(self, encoder_config: TransformerConfig,
                 decoder_config: TransformerConfig,
                 dtype: torch.dtype = torch.bfloat16,
                 mlm_layer: Optional[str] = None,
                 param_dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        """`dtype` is the compute dtype; parameters are stored in
        `param_dtype` (float32 to train, the compute dtype to serve with
        pre-cast weights) and LayerNorm parameters always in float32.
        `remat` recomputes encoder and decoder blocks in the backward."""
        super().__init__()
        self.encoder_config = encoder_config
        self.decoder_config = decoder_config
        self.dtype = dtype
        self.mlm_layer = mlm_layer
        self.encoder = Encoder(encoder_config, dtype, param_dtype, remat)
        self.decoder = Decoder(decoder_config, dtype, param_dtype, remat)
        if mlm_layer:
            self.mlm_head = MLMHead(encoder_config, dtype,
                                    mlp=mlm_layer == "mlp",
                                    param_dtype=param_dtype)
        # dropout is off until a train step turns it on (flax's
        # deterministic=True default)
        self.eval()

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                decoder_input_ids: torch.Tensor,
                decoder_attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                mlm_prefix_len: Optional[int] = None,
                mlm_labels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """In training mode `generator` feeds every dropout. With
        `mlm_labels` the MLM head returns `mlm_loss_sum` and `mlm_valid`
        (linear + CE folded together) instead of `mlm_logits`."""
        enc = self.encoder(input_ids, attention_mask=attention_mask,
                           position_ids=position_ids, generator=generator)
        logits = self.decoder(decoder_input_ids, enc,
                              attention_mask=decoder_attention_mask,
                              encoder_attention_mask=attention_mask,
                              generator=generator)
        out = {"logits": logits, "encoder_last_hidden_state": enc}
        if self.mlm_layer and mlm_prefix_len is not None:
            # masked tokens sit in a contiguous prefix (data/mlm.py)
            if mlm_labels is not None:
                out["mlm_loss_sum"], out["mlm_valid"] = self.mlm_head(
                    enc[:, :mlm_prefix_len], labels=mlm_labels)
            else:
                out["mlm_logits"] = self.mlm_head(enc[:, :mlm_prefix_len])
        return out

    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.encoder(input_ids, attention_mask=attention_mask,
                            position_ids=position_ids)

    def decode_logits(self, decoder_input_ids: torch.Tensor,
                      encoder_states: torch.Tensor,
                      encoder_attention_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """Full-sequence decoding (teacher forcing) given encoder states."""
        return self.decoder(decoder_input_ids, encoder_states,
                            encoder_attention_mask=encoder_attention_mask)


class DecoderStep(nn.Module):
    """Single-token decoder step over a `DecodeCache`, for beam search.

    Holds the trained decoder itself, so the cross K/V cache is projected
    with the trained weights (no fresh init can stand in for them)."""

    def __init__(self, decoder: Decoder):
        super().__init__()
        self.decoder = decoder

    def init_cache(self, encoder_states: torch.Tensor,
                   encoder_attention_mask: Optional[torch.Tensor],
                   num_beams: int, cache_len: int) -> DecodeCache:
        return self.decoder.init_cache(
            encoder_states, encoder_attention_mask,
            encoder_states.shape[0] * num_beams, cache_len)

    def forward(self, token_ids: torch.Tensor, cache: DecodeCache,
                position: int) -> torch.Tensor:
        return self.decoder.decode(token_ids, cache, position)
