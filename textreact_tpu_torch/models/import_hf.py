"""Pretrained BERT/SciBERT checkpoint import (twin of
textreact_tpu/models/import_hf.py).

Role of reference --encoder_pretrained / --decoder_pretrained (model.py:13-31:
HF from_pretrained) plus the embedding-expansion utilities (utils.py:18-44):
copy pretrained rows into the (larger) position/word embedding tables and
keep the seeded initialisation of the rest. Reads a local HF checkpoint
directory, `model.safetensors` first, then `pytorch_model.bin`; nothing is
downloaded. The safetensors format is read here (an 8-byte little-endian
header length, a JSON header, the raw buffer), so neither `safetensors` nor
`transformers` is needed.

The name map is the JAX package's. A torch `Linear` stores (out, in), as HF
does, so no weight is transposed:

    HF (after the `bert.` prefix)                    port (under encoder/decoder)
    embeddings.word_embeddings.weight                embeddings.word_embeddings.weight
                                                     (decoder: word_embedding, tied
                                                     to the LM head), rows copied
    embeddings.position_embeddings.weight            embeddings.position_embeddings.weight, rows
    embeddings.token_type_embeddings.weight          embeddings.token_type_embeddings.weight, rows
    embeddings.LayerNorm.{weight,bias}               embeddings.layer_norm.{weight,bias}
    encoder.layer.<i>.attention.self.{query,key,value}.*   layers.<i>.attention.{query,key,value}.*
    encoder.layer.<i>.attention.output.dense.*       layers.<i>.attention.output.*
    encoder.layer.<i>.attention.output.LayerNorm.*   layers.<i>.attention_norm.*
    encoder.layer.<i>.intermediate.dense.*           layers.<i>.ffn.intermediate.*
    encoder.layer.<i>.output.dense.*                 layers.<i>.ffn.output.*
    encoder.layer.<i>.output.LayerNorm.*             layers.<i>.ffn_norm.*
    cls.predictions.transform.dense.* (decoder)      lm_head.transform.*
    cls.predictions.transform.LayerNorm.* (decoder)  lm_head.transform_norm.*
    cls.predictions.bias (decoder)                   lm_head.bias, rows

BERT has no cross-attention, so the decoder's `crossattention*` keep their
initialisation, as HF does when it grafts a BERT checkpoint into a decoder.
The pooler is not read. Parameters are written in place, so the import
runs before `parallel.sharding.shard_params` cuts them.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Dict, Set

import numpy as np
import torch
from torch import nn

from .config import TransformerConfig

# the safetensors element types the JAX importer reads: with JAX imported,
# numpy knows bfloat16 (ml_dtypes), so safetensors.numpy reads BF16 there
# too; the F8 types are refused, as numpy without ml_dtypes refuses them
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "U64": torch.uint64,
    "I32": torch.int32, "U32": torch.uint32, "I16": torch.int16,
    "U16": torch.uint16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool, "C64": torch.complex64,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a `.safetensors` file, on the CPU (the
    `__metadata__` entry is skipped)."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        start = 8 + header_len
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
            if dtype is None:
                raise TypeError(f"data type {info['dtype']!r} not understood "
                                f"({name} in {path})")
            shape = tuple(info["shape"])
            begin, end = info["data_offsets"]
            itemsize = torch.empty((), dtype=dtype).element_size()
            if end - begin != math.prod(shape) * itemsize:
                raise ValueError(f"{name} in {path}: {end - begin} bytes for "
                                 f"shape {shape} of {info['dtype']}")
            if end == begin:
                out[name] = torch.empty(shape, dtype=dtype)
                continue
            f.seek(start + begin)
            raw = np.fromfile(f, dtype=np.uint8, count=end - begin)
            out[name] = torch.from_numpy(raw).view(dtype).reshape(shape)
    return out


def read_state_dict(ckpt_dir: str) -> Dict[str, torch.Tensor]:
    """The CPU tensors of `ckpt_dir/model.safetensors`, else of
    `ckpt_dir/pytorch_model.bin`. A sharded checkpoint (`*.index.json`)
    is not read, nor a bfloat16 tensor of a `.bin` file (the JAX importer
    goes through numpy there, which refuses it)."""
    st_path = os.path.join(ckpt_dir, "model.safetensors")
    if os.path.exists(st_path):
        return read_safetensors(st_path)
    bin_path = os.path.join(ckpt_dir, "pytorch_model.bin")
    if os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        if any(v.dtype == torch.bfloat16 for v in sd.values()):
            raise TypeError(f"{bin_path}: bfloat16 tensors are not read "
                            f"from a .bin checkpoint")
        return sd
    raise FileNotFoundError(
        f"no model.safetensors / pytorch_model.bin in {ckpt_dir} (a sharded "
        f"checkpoint, *.index.json, is not read)")


class _HFState:
    """A checkpoint's tensors under their names without the `bert.` prefix
    (head keys, `cls.*`, keep theirs), recording which were read under the
    file's own names."""

    def __init__(self, ckpt_dir: str):
        raw = read_state_dict(ckpt_dir)
        strip = any(k.startswith("bert.") for k in raw)
        self.file_name = {(k[len("bert."):] if strip and k.startswith("bert.")
                           else k): k for k in raw}
        self.tensors = {k: raw[v] for k, v in self.file_name.items()}
        self.read: Set[str] = set()

    def __contains__(self, key: str) -> bool:
        return key in self.tensors

    def __getitem__(self, key: str) -> torch.Tensor:
        self.read.add(self.file_name[key])
        return self.tensors[key]


def _copy(param: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if tuple(param.shape) != tuple(src.shape):
        raise ValueError(f"{name}: checkpoint shape {tuple(src.shape)}, "
                         f"model shape {tuple(param.shape)}")
    param.copy_(src)


def _copy_rows(param: torch.Tensor, src: torch.Tensor) -> None:
    """Copy pretrained rows into a possibly larger table; the rest keeps
    its initialisation (reference utils.py:18-44)."""
    n = min(param.shape[0], src.shape[0])
    param[:n].copy_(src[:n])


def _dense(linear: nn.Linear, sd: _HFState, hf: str) -> None:
    _copy(linear.weight, sd[f"{hf}.weight"], f"{hf}.weight")
    _copy(linear.bias, sd[f"{hf}.bias"], f"{hf}.bias")


_norm = _dense   # a LayerNorm's weight and bias, by the same names


def _embeddings_and_layers(module: nn.Module, sd: _HFState,
                           config: TransformerConfig,
                           token_types_required: bool) -> None:
    """Position, token-type (the encoder's must be in the file, the
    decoder's where it is) and LayerNorm of the embeddings, then every
    layer's self-attention and feed-forward."""
    emb = module.embeddings
    _copy_rows(emb.position_embeddings.weight,
               sd["embeddings.position_embeddings.weight"])
    types = "embeddings.token_type_embeddings.weight"
    if hasattr(emb, "token_type_embeddings") and (
            token_types_required or types in sd):
        _copy_rows(emb.token_type_embeddings.weight, sd[types])
    _norm(emb.layer_norm, sd, "embeddings.LayerNorm")
    for i in range(config.num_hidden_layers):
        hf = f"encoder.layer.{i}"
        layer = module.layers[i]
        attn = layer.attention
        _dense(attn.query, sd, f"{hf}.attention.self.query")
        _dense(attn.key, sd, f"{hf}.attention.self.key")
        _dense(attn.value, sd, f"{hf}.attention.self.value")
        _dense(attn.output, sd, f"{hf}.attention.output.dense")
        _norm(layer.attention_norm, sd, f"{hf}.attention.output.LayerNorm")
        _dense(layer.ffn.intermediate, sd, f"{hf}.intermediate.dense")
        _dense(layer.ffn.output, sd, f"{hf}.output.dense")
        _norm(layer.ffn_norm, sd, f"{hf}.output.LayerNorm")


@torch.no_grad()
def load_pretrained_encoder(encoder: nn.Module, ckpt_dir: str,
                            config: TransformerConfig) -> Set[str]:
    """Fill an initialised `Encoder` from an HF BERT checkpoint directory, in
    place; returns the names of the file's tensors that were read."""
    sd = _HFState(ckpt_dir)
    _copy_rows(encoder.embeddings.word_embeddings.weight,
               sd["embeddings.word_embeddings.weight"])
    _embeddings_and_layers(encoder, sd, config, token_types_required=True)
    return sd.read


@torch.no_grad()
def load_pretrained_decoder(decoder: nn.Module, ckpt_dir: str,
                            config: TransformerConfig) -> Set[str]:
    """Fill an initialised `Decoder` from an HF BERT checkpoint directory
    (reference --decoder_pretrained, model.py:22-24), in place; returns the
    names of the file's tensors that were read. The LM head's transform
    and bias come from a MaskedLM checkpoint's `cls.predictions.*` where
    the file has them; its vocab projection is the tied word table."""
    sd = _HFState(ckpt_dir)
    _copy_rows(decoder.word_embedding, sd["embeddings.word_embeddings.weight"])
    _embeddings_and_layers(decoder, sd, config, token_types_required=False)
    if "cls.predictions.transform.dense.weight" in sd:
        head = decoder.lm_head
        _dense(head.transform, sd, "cls.predictions.transform.dense")
        _norm(head.transform_norm, sd, "cls.predictions.transform.LayerNorm")
        if "cls.predictions.bias" in sd:
            _copy_rows(head.bias, sd["cls.predictions.bias"])
    return sd.read
