"""Top-level models (twin of textreact_tpu/models/encdec.py): the seq2seq
encoder-decoder and its one-token decode step, and the template-based
predictor (reference textreact/model.py: TemplateBasedModel,
TemplatePredictionHead, BondTemplatePredictor).

As in the JAX package, the bond-template head factors the reference's
pairwise-concat linear (model.py:80-90: logits[i,j] = W @ [h_i; h_j]) into
two dense maps summed at gathered bond pairs, so no (B, L, L, 2d) concat
and no (B, L, L, n_b) dense logits are made; atom states are gathered with
one batched gather along the padded atom-index tensor.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span
from .config import TransformerConfig
from .decoder import DecodeCache, Decoder
from .encoder import Encoder
from .layers import MLMHead, Position


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
    """Single-token decoder step over a `DecodeCache`, for beam search
    (encdec.py:88-112).

    Holds the trained decoder itself, so the cross K/V cache is projected
    with the trained weights (no fresh init can stand in for them). With
    beam_groups = G > 0 the self-attention cache takes the row-stable
    grouped beam layout and each step needs the ancestry bias (B, G,
    W*G); with 0 it decodes per row under plain positional masking."""

    def __init__(self, decoder: Decoder, beam_groups: int = 0):
        super().__init__()
        self.decoder = decoder
        self.beam_groups = beam_groups

    def init_cache(self, encoder_states: torch.Tensor,
                   encoder_attention_mask: Optional[torch.Tensor],
                   num_beams: int, cache_len: int) -> DecodeCache:
        if self.beam_groups not in (0, num_beams):
            raise ValueError(f"{num_beams} beams in a step model of "
                             f"{self.beam_groups} beam groups")
        return self.decoder.init_cache(
            encoder_states, encoder_attention_mask,
            encoder_states.shape[0] * num_beams, cache_len, self.beam_groups)

    def refill_cache(self, cache: DecodeCache, encoder_states: torch.Tensor,
                     encoder_attention_mask: Optional[torch.Tensor]) -> None:
        """A new batch of init_cache's shapes into `cache`, in place
        (Decoder.refill_cache)."""
        self.decoder.refill_cache(cache, encoder_states,
                                  encoder_attention_mask)

    def forward(self, token_ids: torch.Tensor, cache: DecodeCache,
                position: Position,
                beam_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`position`: an int, or a 0-d int64 tensor on the cache's
        device."""
        return self.decoder.decode(token_ids, cache, position, beam_bias)


class TemplateHead(nn.Module):
    """Atom + factored bond template classifiers. All three maps are flax
    `nn.Dense(dtype=float32)` (encdec.py:131-138): under a bf16 compute
    dtype they promote the bf16 atom states to f32 and compute in f32, so
    they do not go through `layers.Linear`, which casts to the compute
    dtype."""

    def __init__(self, hidden_size: int, num_atom_templates: int,
                 num_bond_templates: int,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.atom_head = nn.Linear(hidden_size, num_atom_templates + 1,
                                   dtype=param_dtype)
        self.bond_head_left = nn.Linear(hidden_size, num_bond_templates + 1,
                                        dtype=param_dtype)
        self.bond_head_right = nn.Linear(hidden_size, num_bond_templates + 1,
                                         bias=False, dtype=param_dtype)

    @staticmethod
    def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        bias = None if layer.bias is None else layer.bias.float()
        return F.linear(x.float(), layer.weight.float(), bias)

    def forward(self, atom_states: torch.Tensor, bond_pairs: torch.Tensor):
        """atom_states: (B, A, d); bond_pairs: (B, MB, 2) indices into A.
        Returns atom_logits (B, A, n_a+1), bond_logits (B, MB, n_b+1), f32."""
        atom_logits = self._dense(self.atom_head, atom_states)
        # factored pair head: W [h_i; h_j] + b == W1 h_i + (W2 h_j)
        left = self._dense(self.bond_head_left, atom_states)
        right = self._dense(self.bond_head_right, atom_states)
        n = left.shape[-1]
        pairs = bond_pairs.long()
        li = torch.gather(left, 1, pairs[:, :, 0:1].expand(-1, -1, n))
        rj = torch.gather(right, 1, pairs[:, :, 1:2].expand(-1, -1, n))
        return atom_logits, li + rj


class TemplateBasedModel(nn.Module):
    """Encoder + template heads (template-based retrosynthesis)."""

    def __init__(self, encoder_config: TransformerConfig,
                 num_atom_templates: int, num_bond_templates: int,
                 dtype: torch.dtype = torch.bfloat16,
                 mlm_layer: Optional[str] = None,
                 param_dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.encoder_config = encoder_config
        self.num_atom_templates = num_atom_templates
        self.num_bond_templates = num_bond_templates
        self.dtype = dtype
        self.mlm_layer = mlm_layer
        self.encoder = Encoder(encoder_config, dtype, param_dtype, remat)
        self.head = TemplateHead(encoder_config.hidden_size,
                                 num_atom_templates, num_bond_templates,
                                 param_dtype)
        if mlm_layer:
            self.mlm_head = MLMHead(encoder_config, dtype,
                                    mlp=mlm_layer == "mlp",
                                    param_dtype=param_dtype)
        self.eval()

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                atom_indices: torch.Tensor, bond_pairs: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                mlm_prefix_len: Optional[int] = None,
                mlm_labels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """`attention_mask` is (B, L), or (B, L, L) under
        --unattend_nonbonds; a 3-D mask becomes an additive bias, so the
        self-attention takes the plain path (layers.py:201-203). The
        gather and the heads run inside the span `template.head`."""
        enc = self.encoder(input_ids, attention_mask=attention_mask,
                           position_ids=position_ids, generator=generator)
        with span("template.head"):
            # batched gather of atom-token states: (B, A, d)
            idx = atom_indices.long()[:, :, None].expand(-1, -1,
                                                         enc.shape[-1])
            atom_states = torch.gather(enc, 1, idx)
            atom_logits, bond_logits = self.head(atom_states, bond_pairs)
        out = {"logits": (atom_logits, bond_logits),
               "encoder_last_hidden_state": enc}
        if self.mlm_layer and mlm_prefix_len is not None:
            if mlm_labels is not None:
                out["mlm_loss_sum"], out["mlm_valid"] = self.mlm_head(
                    enc[:, :mlm_prefix_len], labels=mlm_labels)
            else:
                out["mlm_logits"] = self.mlm_head(enc[:, :mlm_prefix_len])
        return out
