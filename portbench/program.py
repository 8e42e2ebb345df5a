"""How the benchmark builds the system under test: the port's own entry
points (`build_model`, `make_optimizer`, `make_accum_train_step`,
`Generator`) from a configuration file's sizes, with the benchmark's
weights loaded in place of the ones `build_model` draws.

`build_model` reads the encoder's and decoder's sizes from JSON files:
the benchmark writes them under `portbench/.work/`, a fixed directory
inside the checkout. No tokenizer is built: the traffic draws token ids,
and the factory needs only the vocabularies' sizes and special ids.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
WORK = HERE / ".work"


class Vocab:
    """What `build_model` reads of a tokenizer."""

    def __init__(self, size: int, pad: int, bos: int = 0, eos: int = 0):
        self.size = size
        self.pad_token_id, self.bos_token_id, self.eos_token_id = pad, bos, eos

    def __len__(self) -> int:
        return self.size


def load_config(name: str) -> dict:
    path = HERE / "configs" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no configuration {name!r} ({path})")
    return json.loads(path.read_text())


def experiment(cfg: dict, name: str, mode: str, seed: int):
    """The port's ExperimentConfig of configuration `cfg` in `mode`
    ('train' or 'serve')."""
    from textreact_tpu_torch.config import ExperimentConfig
    WORK.mkdir(exist_ok=True)
    paths = {}
    for part in ("encoder", "decoder"):
        path = WORK / f"{name}.{part}.json"
        text = json.dumps(cfg[part], indent=1, sort_keys=True)
        if not path.is_file() or path.read_text() != text:
            path.write_text(text)
        paths[part] = str(path)
    train = mode == "train"
    return ExperimentConfig(
        task=cfg["task"], seed=seed, encoder=paths["encoder"],
        decoder=paths["decoder"], max_length=cfg["max_length"],
        max_dec_length=(cfg["max_dec_length"] if train
                        else cfg["serve_max_dec_length"]),
        mlm=train, mlm_ratio=cfg["mlm_ratio"], mlm_layer=cfg["mlm_layer"],
        mlm_lambda=cfg["mlm_lambda"], lr=cfg["lr"],
        weight_decay=cfg["weight_decay"], max_grad_norm=cfg["max_grad_norm"],
        scheduler=cfg["scheduler"], warmup_ratio=cfg["warmup_ratio"],
        num_beams=cfg["num_beams"], compute_dtype=cfg["compute_dtype"],
        param_dtype=(cfg["param_dtype"] if train else cfg["serve_dtype"]),
        length_buckets=tuple(cfg["length_buckets"]),
        dec_length_buckets=tuple(cfg["dec_length_buckets"]),
        attention_impl="flash", layernorm_impl="fused")


def build(cfg: dict, exp, device):
    """(module, enc_config, dec_config) from the port's factory."""
    from textreact_tpu_torch.models import build_model
    e, d = cfg["encoder_ids"], cfg["decoder_ids"]
    enc_vocab = Vocab(cfg["encoder"]["vocab_size"], e["pad"])
    dec_vocab = Vocab(cfg["decoder"]["vocab_size"], d["pad"], d["bos"],
                      d["eos"])
    return build_model(exp, enc_vocab, dec_vocab, device=device)


def build_kernels() -> None:
    """Build (or find built) the libraries of the kernels the cells run,
    side by side."""
    from textreact_tpu_torch.ops import _build
    _build.build_all(["fused_attention", "fused_attention_bwd",
                      "fused_layernorm"])


def dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
