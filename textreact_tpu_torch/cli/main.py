"""CLI entrypoint (twin of textreact_tpu/cli/main.py): the reference flag
surface (main.py:26-97), so the six reference training scripts translate
1:1, the JAX package's framework flags, and --device.

Usage:  python -m textreact_tpu_torch --task condition --do_train ...

Runs on the CUDA card; `--device cpu` is for rehearsals and tests. On
several devices, one process each, start it with torchrun:

    python -m torch.distributed.run --nproc_per_node 4 -m textreact_tpu_torch \
        --dp_size 2 --tp_size 2 --zero1 ...

(NCCL between cards; with `--device cpu` the processes join over gloo).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from ..config import ExperimentConfig
from ..train.trainer import run


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="textreact_tpu_torch")
    p.add_argument("--task", type=str, default="condition")
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_valid", action="store_true")
    p.add_argument("--do_test", action="store_true")
    p.add_argument("--precision", type=str, default="bf16",
                   help="compat flag: 16/16-mixed map to bfloat16 compute")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--gpus", type=int, default=None,
                   help="compat no-op: torchrun's --nproc_per_node sets "
                        "the processes")
    p.add_argument("--print_freq", type=int, default=200)
    p.add_argument("--debug", action="store_true")
    # Model
    p.add_argument("--template_based", action="store_true")
    p.add_argument("--unattend_nonbonds", action="store_true")
    p.add_argument("--encoder", type=str, default=None)
    p.add_argument("--decoder", type=str, default=None)
    p.add_argument("--encoder_pretrained", action="store_true")
    p.add_argument("--decoder_pretrained", action="store_true")
    p.add_argument("--share_embedding", action="store_true")
    p.add_argument("--encoder_tokenizer", type=str, default="text")
    # Data
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--template_path", type=str, default=None)
    p.add_argument("--train_file", type=str, default=None)
    p.add_argument("--valid_file", type=str, default=None)
    p.add_argument("--test_file", type=str, default=None)
    p.add_argument("--vocab_file", type=str, default=None)
    p.add_argument("--text_vocab_file", type=str, default=None)
    p.add_argument("--corpus_file", type=str, default=None)
    p.add_argument("--train_label_corpus", action="store_true")
    p.add_argument("--cache_path", type=str, default=None)
    p.add_argument("--nn_path", type=str, default=None)
    p.add_argument("--train_nn_file", type=str, default=None)
    p.add_argument("--valid_nn_file", type=str, default=None)
    p.add_argument("--test_nn_file", type=str, default=None)
    p.add_argument("--max_length", type=int, default=128)
    p.add_argument("--max_dec_length", type=int, default=128)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--shuffle_smiles", action="store_true")
    p.add_argument("--no_smiles", action="store_true")
    p.add_argument("--num_neighbors", type=int, default=-1)
    p.add_argument("--use_gold_neighbor", action="store_true")
    p.add_argument("--max_num_neighbors", type=int, default=10)
    p.add_argument("--random_neighbor_ratio", type=float, default=0.8)
    p.add_argument("--mlm", action="store_true")
    p.add_argument("--mlm_ratio", type=float, default=0.15)
    p.add_argument("--mlm_layer", type=str, default="linear")
    p.add_argument("--mlm_impl", type=str, choices=["fused", "xla"],
                   default="fused")
    p.add_argument("--mlm_lambda", type=float, default=1.0)
    # Training
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=256,
                   help="GLOBAL batch size")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--max_grad_norm", type=float, default=5.0)
    p.add_argument("--scheduler", type=str, choices=["cosine", "constant"],
                   default="cosine")
    p.add_argument("--warmup", "--warmup_ratio", dest="warmup_ratio",
                   type=float, default=0.0)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--load_ckpt", type=str, default="best")
    p.add_argument("--eval_per_epoch", type=int, default=1)
    p.add_argument("--val_metric", type=str, default="val_acc")
    p.add_argument("--save_path", type=str, default="output/")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--num_train_example", type=int, default=None)
    p.add_argument("--label_smoothing", type=float, default=0.0)
    # Inference
    p.add_argument("--test_batch_size", type=int, default=64)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--test_each_neighbor", action="store_true")
    p.add_argument("--test_num_neighbors", type=int, default=1)
    # framework flags
    p.add_argument("--dp_size", type=int, default=-1)
    p.add_argument("--tp_size", type=int, default=1)
    p.add_argument("--param_dtype", type=str, default="float32")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--layernorm_impl", type=str, choices=["xla", "fused"],
                   default="fused")
    p.add_argument("--attention_impl", type=str, choices=["xla", "flash"],
                   default="flash")
    p.add_argument("--decode_scores_dtype", type=str,
                   choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--dropout_rng_impl", type=str,
                   choices=["threefry2x32", "rbg", "unsafe_rbg"],
                   default="unsafe_rbg")
    p.add_argument("--zero1", action="store_true",
                   help="shard optimizer moments over the dp axis (ZeRO-1)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the CUDA card (raises "
                        "without one)")
    return p


def parse_config(argv: Optional[List[str]] = None) -> ExperimentConfig:
    return _parse(argv)[0]


def _parse(argv: Optional[List[str]]):
    """(ExperimentConfig, device or None)."""
    ns = build_parser().parse_args(argv)
    d = vars(ns)
    device = d.pop("device", None)
    # compat flags with no ExperimentConfig field
    d.pop("gpus", None)
    d.pop("print_freq", None)
    precision = d.pop("precision", "bf16")
    if precision in ("16", "16-mixed", "bf16", "bf16-mixed"):
        d["compute_dtype"] = "bfloat16"
    elif precision == "32":
        d["compute_dtype"] = "float32"
    # normalize a 'best.ckpt' style name to manager name 'best'
    if d.get("load_ckpt", "").endswith(".ckpt"):
        d["load_ckpt"] = d["load_ckpt"][: -len(".ckpt")]
    return ExperimentConfig(**d).validate(), device


def main(argv: Optional[List[str]] = None):
    cfg, device = _parse(argv)
    return run(cfg, device=device)


if __name__ == "__main__":
    main()
