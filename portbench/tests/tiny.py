"""A tiny configuration, traffic mixes and cells for the benchmark's CPU
tests: the harness's files copied into a temporary checkout, these added
beside them (no file of the copy is edited), and a cell run on the CPU
through `portbench.run.main` in a subprocess."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent

CONFIG = {
    "source": "tiny", "reference": "encdec", "task": "condition",
    "encoder": {"vocab_size": 300, "hidden_size": 128,
                "num_hidden_layers": 2, "num_attention_heads": 2,
                "intermediate_size": 256, "max_position_embeddings": 128,
                "type_vocab_size": 2, "hidden_dropout_prob": 0.1,
                "attention_probs_dropout_prob": 0.1, "layer_norm_eps": 1e-12,
                "hidden_act": "gelu", "initializer_range": 0.02,
                "pad_token_id": 0},
    "decoder": {"vocab_size": 40, "hidden_size": 128,
                "num_hidden_layers": 1, "num_attention_heads": 2,
                "intermediate_size": 256, "max_position_embeddings": 64,
                "type_vocab_size": 1, "hidden_dropout_prob": 0.1,
                "attention_probs_dropout_prob": 0.1, "layer_norm_eps": 1e-5,
                "hidden_act": "gelu", "initializer_range": 0.02,
                "pad_token_id": 0, "bos_token_id": 1, "eos_token_id": 2},
    "encoder_ids": {"pad": 0, "cls": 2, "sep": 3, "mask": 4,
                    "first_word": 5, "vocab_size": 300},
    "decoder_ids": {"pad": 0, "bos": 1, "eos": 2, "first_token": 3,
                    "last_token": 39},
    "max_length": 128, "max_dec_length": 32,
    "length_buckets": [64, 128], "dec_length_buckets": [16, 32],
    "mlm_ratio": 0.15, "mlm_layer": "mlp", "mlm_lambda": 0.1,
    "compute_dtype": "float32", "param_dtype": "float32",
    "lr": 1e-4, "weight_decay": 0.01, "max_grad_norm": 5.0,
    "scheduler": "cosine", "warmup_ratio": 0.0, "num_training_steps": 1000,
    "serve_dtype": "float32", "num_beams": 3, "serve_max_dec_length": 8,
    "attn_windows": None, "reduced": []}

TRAIN = {"kind": "train", "micro_batches": 2, "micro_batch_size": 4,
         "pool_steps": 3, "checked_steps": 3, "trace_units": 1,
         "prompt": {"length": 128, "long_share": 0.5,
                    "short_lengths": [16, 64]},
         "mlm": {"ratio": 0.15, "mean_span": 3, "max_span": 10},
         "target": {"fixed": 12}}

SERVE = {"kind": "serve", "batch_size": 4, "pool_batches": 3,
         "warmup_batches": 1, "checked_requests": 2, "trace_units": 1,
         "rate_metric": "serve_requests_per_s.rcr", "latency_tail": True,
         "prompt": {"length": 128, "long_share": 0.5,
                    "short_lengths": [16, 64]}}

TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-3}
SERVE_LIMITS = {"score_gap": 1e-3, "select_gap": 1e-4}

METRIC = '''"""Test metric: the traced slice's launch calls."""


def read(facts):
    return float(facts["slice"].launch_calls)
'''


def checkout(tmp: Path) -> Path:
    """A copy of BENCHMARK.json and portbench/ with the tiny files added
    (and one more per-layer metric), as a later change would add them."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".work",
                                                  ".cache", "out"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    (pb / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    (pb / "traffic" / "tiny_train.json").write_text(json.dumps(TRAIN))
    (pb / "traffic" / "tiny_serve.json").write_text(json.dumps(SERVE))
    (pb / "metrics" / "tiny.launch_calls.py").write_text(METRIC)
    for cell, limits in (("tiny.train", TRAIN_LIMITS),
                         ("tiny.serve", SERVE_LIMITS)):
        (pb / "limits" / f"{cell}.json").write_text(json.dumps(
            {"numbers": {k: {"limit": v} for k, v in limits.items()}}))
    bench["configs"].append({"name": "tiny", "source": "tiny",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"] += [
        {"name": "tiny.train", "config": "tiny", "traffic": "tiny_train",
         "chips": 1, "why": "tests"},
        {"name": "tiny.serve", "config": "tiny", "traffic": "tiny_serve",
         "chips": 1, "why": "tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        names = m.get("workloads", [])
        if "rcr.train" in names:
            names.append("tiny.train")
        if "rcr.serve" in names:
            names.append("tiny.serve")
    bench["per_layer"].append(
        {"name": "tiny.launch_calls", "unit": "calls", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "setup_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


DRIVER = '''
import sys
sys.path.insert(0, {root!r})
sys.path.append({repo!r})
from portbench import run
{prelude}
try:
    run.main({argv!r}, device="cpu")
except run.RunError as e:
    print("RunError:", e, file=sys.stderr)
    sys.exit(3)
'''


def run_cell(root: Path, cell: str, trace: int = 0, seed: int = 2**31 + 7,
             prelude: str = "", timeout: float = 600):
    """(returncode, stdout, stderr) of one CPU run of `cell` in `root`;
    `prelude` runs first in that process (to plant a fault)."""
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
            "--trace", str(trace)]
    code = DRIVER.format(root=str(root), repo=str(REPO), prelude=prelude,
                         argv=argv)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
