from .config import (BERT_L6_DECODER, PRESETS, SCIBERT_BASE,
                     TransformerConfig, resolve_config)
from .convert import from_flax
from .decoder import DecodeCache, Decoder
from .encdec import DecoderStep, EncoderDecoder
from .encoder import Encoder
from .factory import build_model, init_weights

__all__ = [
    "BERT_L6_DECODER", "PRESETS", "SCIBERT_BASE", "TransformerConfig",
    "resolve_config", "from_flax", "DecodeCache", "Decoder", "DecoderStep",
    "EncoderDecoder", "Encoder", "build_model", "init_weights",
]
