"""Transformer model configuration (twin of textreact_tpu/models/config.py).

A copy rather than an import: importing `textreact_tpu.models` loads the
flax modules, and the port must run where JAX is not installed. The fields,
presets and resolution rules are the JAX package's, so one experiment
config names the same geometry in both packages.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 600
    hidden_size: int = 768
    num_hidden_layers: int = 6
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 1
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    hidden_act: str = "gelu"
    pad_token_id: int = 0
    bos_token_id: int = 12
    eos_token_id: int = 13
    is_decoder: bool = False
    add_cross_attention: bool = False
    # 'xla' (plain torch attention) or 'flash' (the fused attention kernel,
    # ops/fused_attention.py) where the shapes allow it (layers.py gate)
    attention_impl: str = "xla"
    # beam-decode self-attention QK score storage: the model dtype or
    # 'float32' (layers.py self-attention decode)
    decode_scores_dtype: str = "bfloat16"
    # residual-add + LayerNorm: 'xla' (plain torch) or 'fused' (the kernel,
    # ops/fused_layernorm.py) when the hidden size is a multiple of 128
    layernorm_impl: str = "xla"

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_attention_heads == 0
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_json(cls, path: str, **overrides) -> "TransformerConfig":
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in fields}
        kwargs.update(overrides)
        return cls(**kwargs)

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


# SciBERT-base geometry (allenai/scibert_scivocab_uncased): BERT-base with a
# 31090-token scientific vocab.
SCIBERT_BASE = TransformerConfig(
    vocab_size=31090, hidden_size=768, num_hidden_layers=12,
    num_attention_heads=12, intermediate_size=3072,
    max_position_embeddings=512, type_vocab_size=2, pad_token_id=0,
)

# The reference's 6-layer decoder config (textreact/configs/bert_l6.json).
BERT_L6_DECODER = TransformerConfig(
    vocab_size=600, hidden_size=768, num_hidden_layers=6,
    num_attention_heads=12, intermediate_size=3072,
    max_position_embeddings=512, type_vocab_size=1,
    pad_token_id=0, bos_token_id=12, eos_token_id=13,
    is_decoder=True, add_cross_attention=True,
)

PRESETS = {
    "scibert_base": SCIBERT_BASE,
    "allenai/scibert_scivocab_uncased": SCIBERT_BASE,
    "bert_l6": BERT_L6_DECODER,
}


def resolve_config(name_or_path: Optional[str], **overrides) -> TransformerConfig:
    """Preset name, json path, or HF checkpoint dir -> TransformerConfig."""
    if name_or_path is None:
        raise ValueError("model config name/path required")
    if name_or_path in PRESETS:
        return PRESETS[name_or_path].replace(**overrides) if overrides else PRESETS[name_or_path]
    if os.path.isdir(name_or_path):
        return TransformerConfig.from_json(
            os.path.join(name_or_path, "config.json"), **overrides)
    if name_or_path.endswith(".json"):
        return TransformerConfig.from_json(name_or_path, **overrides)
    raise ValueError(f"unknown model config: {name_or_path!r}")
