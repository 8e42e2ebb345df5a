"""The weights of a cell, made from the seed on the device in a few large
draws, by names and shapes that follow from the configuration's sizes.

One state dict serves both sides: the benchmark loads it into the
program's module (every name must match, `load_into`) and hands the same
tensors to the plain reference. Matrices and embedding tables are drawn
from N(0, initializer_range); the biases of the products from the same,
so that a fault that drops a bias shows; LayerNorm scales are 1 + N(0,
initializer_range) and their biases N(0, initializer_range). Tensors are
made in the dtypes they are served in: `param_dtype` for products and
tables, float32 for LayerNorm parameters and the tied LM head's bias,
which the program keeps in float32 in every mode; the MLM head's output
layer is float32 (the program's untyped dense layer).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str]   # name, shape, kind


def _block(prefix: str, d: int, f: int, cross: bool) -> List[Spec]:
    out: List[Spec] = []
    parts = ["attention"] + (["crossattention"] if cross else [])
    for part in parts:
        for proj in ("query", "key", "value", "output"):
            out += [(f"{prefix}.{part}.{proj}.weight", (d, d), "matrix"),
                    (f"{prefix}.{part}.{proj}.bias", (d,), "bias")]
        out += [(f"{prefix}.{part}_norm.weight", (d,), "ln_scale"),
                (f"{prefix}.{part}_norm.bias", (d,), "ln_bias")]
    out += [(f"{prefix}.ffn.intermediate.weight", (f, d), "matrix"),
            (f"{prefix}.ffn.intermediate.bias", (f,), "bias"),
            (f"{prefix}.ffn.output.weight", (d, f), "matrix"),
            (f"{prefix}.ffn.output.bias", (d,), "bias"),
            (f"{prefix}.ffn_norm.weight", (d,), "ln_scale"),
            (f"{prefix}.ffn_norm.bias", (d,), "ln_bias")]
    return out


def _embeddings(prefix: str, cfg: dict, own_words: bool) -> List[Spec]:
    d = cfg["hidden_size"]
    out: List[Spec] = []
    if own_words:
        out.append((f"{prefix}.word_embeddings.weight",
                    (cfg["vocab_size"], d), "matrix"))
    out.append((f"{prefix}.position_embeddings.weight",
                (cfg["max_position_embeddings"], d), "matrix"))
    if cfg["type_vocab_size"] > 0:
        out.append((f"{prefix}.token_type_embeddings.weight",
                    (cfg["type_vocab_size"], d), "matrix"))
    out += [(f"{prefix}.layer_norm.weight", (d,), "ln_scale"),
            (f"{prefix}.layer_norm.bias", (d,), "ln_bias")]
    return out


def _head(prefix: str, d: int) -> List[Spec]:
    return [(f"{prefix}.transform.weight", (d, d), "matrix"),
            (f"{prefix}.transform.bias", (d,), "bias"),
            (f"{prefix}.transform_norm.weight", (d,), "ln_scale"),
            (f"{prefix}.transform_norm.bias", (d,), "ln_bias")]


def specs(enc: dict, dec: dict, mlm: bool) -> List[Spec]:
    """Every parameter of the encoder-decoder (with the MLM head when
    `mlm`), in the program's naming."""
    d, f = enc["hidden_size"], enc["intermediate_size"]
    out = _embeddings("encoder.embeddings", enc, True)
    for i in range(enc["num_hidden_layers"]):
        out += _block(f"encoder.layers.{i}", d, f, cross=False)
    dd, df = dec["hidden_size"], dec["intermediate_size"]
    out.append(("decoder.word_embedding", (dec["vocab_size"], dd), "matrix"))
    out += _embeddings("decoder.embeddings", dec, False)
    for i in range(dec["num_hidden_layers"]):
        out += _block(f"decoder.layers.{i}", dd, df, cross=True)
    out += [("decoder.lm_head.bias", (dec["vocab_size"],), "f32_bias")]
    out += _head("decoder.lm_head", dd)
    if mlm:
        out += _head("mlm_head", d)
        out += [("mlm_head.decoder.weight", (enc["vocab_size"], d),
                 "f32_matrix"),
                ("mlm_head.decoder.bias", (enc["vocab_size"],), "f32_bias")]
    return out


def make(spec: List[Spec], seed: int, std: float, param_dtype: torch.dtype,
         device) -> Dict[str, torch.Tensor]:
    """The state dict of `spec`, drawn from `seed` on `device`: one normal
    draw for all of it, cut into the tensors."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 0x2545F4914F6CDD1D + 0x1234567) & ((1 << 63) - 1))
    total = sum(torch.Size(shape).numel() for _, shape, _ in spec)
    flat = torch.randn(total, generator=gen, device=device).mul_(std)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind in spec:
        n = torch.Size(shape).numel()
        t = flat[at:at + n].view(shape)
        at += n
        if kind == "ln_scale":
            t = t + 1.0
        dtype = (param_dtype if kind in ("matrix", "bias") else
                 torch.float32)
        out[name] = t.to(dtype).clone()
    return out


def load_into(module: torch.nn.Module, state: Dict[str, torch.Tensor]
              ) -> None:
    """Copy `state` into `module`'s parameters in place: every name the
    module has, no other, each in the dtype it is served in."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError(f"weights: the module lacks {extra[:4]} and has no "
                       f"weights for {missing[:4]}")
    with torch.no_grad():
        for name, p in params.items():
            t = state[name]
            if p.shape != t.shape or p.dtype != t.dtype:
                raise ValueError(f"weights: {name} is {p.dtype}"
                                 f"{tuple(p.shape)} in the module, "
                                 f"{t.dtype}{tuple(t.shape)} here")
            p.copy_(t)
