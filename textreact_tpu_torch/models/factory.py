"""Model factory: experiment config + tokenizers -> torch module (twin of
textreact_tpu/models/factory.py): seq2seq, or template-based where the
decoder "tokenizer" is the TemplateTables."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ExperimentConfig
from ..ops.decode_attention import MAX_HEAD_DIM
from ..ops.fused_attention import HEAD_DIM_MULTIPLE, kernel_head_dim
from ..ops.fused_layernorm import MAX_HIDDEN, takes_hidden
from .config import TransformerConfig, resolve_config
from .decoder import Decoder
from .encdec import EncoderDecoder, TemplateBasedModel
from .layers import LayerNorm, MLMHead, ResidualLayerNorm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. Raises where no card is found: nothing falls back to
    the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "passes device='cpu'")
    return torch.device("cuda")


def check_kernel_shapes(config: TransformerConfig,
                        attention: bool = True, decode: bool = False) -> None:
    """Refuse, before any batch, a model that would reach a kernel with a
    shape the port's kernels do not take: a head dim that is no multiple of
    8 or above 128 under attention_impl='flash', or a hidden size that is a
    multiple of 128 (the reference's rule for its LN kernel, layers.py:374)
    above MAX_HIDDEN under layernorm_impl='fused'. The JAX package's Pallas
    kernels take those shapes; on the card the port has no kernel for them
    and runs no plain version in a kernel's place. The plain functions
    (impl 'xla') take any shape. `attention=False` for a stack whose
    attention always carries a bias and so never reaches the kernels (the
    decoder's, layers.py:201-203). `decode=True` for a decoder that beam
    search runs: its grouped self-attention is a kernel on the card
    (ops/decode_attention.py), which takes head dims up to MAX_HEAD_DIM."""
    if (attention and config.attention_impl == "flash"
            and not kernel_head_dim(config.head_dim)):
        raise ValueError(
            f"head dim {config.head_dim} (hidden {config.hidden_size} / "
            f"{config.num_attention_heads} heads): the attention kernels take "
            f"multiples of {HEAD_DIM_MULTIPLE} up to 128; use "
            f"attention_impl='xla' for others")
    if decode and config.head_dim > MAX_HEAD_DIM:
        raise ValueError(
            f"decoder head dim {config.head_dim} (hidden "
            f"{config.hidden_size} / {config.num_attention_heads} heads): the "
            f"decode attention kernel takes head dims up to {MAX_HEAD_DIM}")
    if (config.layernorm_impl == "fused" and config.hidden_size % 128 == 0
            and not takes_hidden(config.hidden_size)):
        raise ValueError(
            f"hidden size {config.hidden_size}: the LayerNorm kernel takes "
            f"multiples of 128 up to {MAX_HIDDEN}; use "
            f"layernorm_impl='xla' for others")


def build_model(cfg: ExperimentConfig, enc_tokenizer, dec_tokenizer,
                generator: Optional[torch.Generator] = None, device=None):
    """Returns (module, enc_config, dec_config), on `device` (None: the CUDA
    card; raises without one), in eval mode, with weights drawn from
    `generator` (seeded with cfg.seed when None). Template-based models
    have no decoder: dec_config is None.

    Parameters are stored in cfg.param_dtype: 'float32' (the default, what
    training needs) or the compute dtype's name for pre-cast serving
    weights; the compute dtype is cfg.compute_dtype."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    enc_config = resolve_config(cfg.encoder)
    enc_config = enc_config.replace(
        max_position_embeddings=max(enc_config.max_position_embeddings,
                                    cfg.max_length),
        vocab_size=max(enc_config.vocab_size, len(enc_tokenizer)),
        attention_impl=cfg.attention_impl,
        layernorm_impl=cfg.layernorm_impl,
    )
    mlm_layer = cfg.mlm_layer if cfg.mlm else None
    if cfg.template_based:
        tables = dec_tokenizer  # TemplateTables
        if device.type == "cuda":
            check_kernel_shapes(enc_config)
        module = TemplateBasedModel(
            encoder_config=enc_config,
            num_atom_templates=tables.num_atom_templates,
            num_bond_templates=tables.num_bond_templates,
            dtype=DTYPES[cfg.compute_dtype], mlm_layer=mlm_layer,
            param_dtype=DTYPES[cfg.param_dtype], remat=cfg.remat)
        init_weights(module, generator)
        return module.to(device).eval(), enc_config, None
    dec_config = resolve_config(cfg.decoder)
    dec_config = dec_config.replace(
        vocab_size=max(dec_config.vocab_size, len(dec_tokenizer)),
        max_position_embeddings=max(dec_config.max_position_embeddings,
                                    cfg.max_dec_length),
        is_decoder=True, add_cross_attention=True,
        attention_impl=cfg.attention_impl,
        layernorm_impl=cfg.layernorm_impl,
        decode_scores_dtype=cfg.decode_scores_dtype,
        pad_token_id=dec_tokenizer.pad_token_id,
        bos_token_id=dec_tokenizer.bos_token_id,
        eos_token_id=dec_tokenizer.eos_token_id,
    )
    if device.type == "cuda":
        check_kernel_shapes(enc_config)
        check_kernel_shapes(dec_config, attention=False, decode=True)
    module = EncoderDecoder(encoder_config=enc_config,
                            decoder_config=dec_config,
                            dtype=DTYPES[cfg.compute_dtype],
                            mlm_layer=mlm_layer,
                            param_dtype=DTYPES[cfg.param_dtype],
                            remat=cfg.remat)
    init_weights(module, generator)
    return module.to(device).eval(), enc_config, dec_config


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisers: normal(0, initializer_range) for
    dense kernels and embedding tables, zero biases, unit LN scales; the
    template heads (TemplateBasedModel) take normal(0, the encoder's
    initializer_range) and a zero bias, as encdec.py:129 draws them. Values
    are drawn in f32 on the CPU, so a seed gives the same model on any
    device and in any compute dtype."""

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.empty(p.shape).normal_(0.0, std, generator=generator))

    if isinstance(module, TemplateBasedModel):
        parts = [(module.encoder, module.encoder_config),
                 (module.head, module.encoder_config)]
    else:
        parts = [(module.encoder, module.encoder_config),
                 (module.decoder, module.decoder_config)]
    if module.mlm_layer:
        parts.append((module.mlm_head, module.encoder_config))
    for part, config in parts:
        std = config.initializer_range
        for m in part.modules():
            if isinstance(m, nn.Linear):
                normal_(m.weight, std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                normal_(m.weight, std)
            elif isinstance(m, (LayerNorm, ResidualLayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, MLMHead) and hasattr(m, "bias"):
                m.bias.zero_()
            elif isinstance(m, Decoder):
                normal_(m.word_embedding, std)
