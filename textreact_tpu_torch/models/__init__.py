from .config import (BERT_L6_DECODER, PRESETS, SCIBERT_BASE,
                     TransformerConfig, resolve_config)
from .convert import from_flax, grads_from_flax
from .decoder import DecodeCache, Decoder
from .encdec import (DecoderStep, EncoderDecoder, TemplateBasedModel,
                     TemplateHead)
from .encoder import Encoder
from .factory import build_model, init_weights, resolve_device

__all__ = [
    "BERT_L6_DECODER", "PRESETS", "SCIBERT_BASE", "TransformerConfig",
    "resolve_config", "from_flax", "grads_from_flax", "DecodeCache",
    "Decoder", "DecoderStep", "EncoderDecoder", "TemplateBasedModel",
    "TemplateHead", "Encoder", "build_model",
    "init_weights", "resolve_device",
]
