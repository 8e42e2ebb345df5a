"""A tiny template-based configuration, traffic mix and cell for the
benchmark's CPU tests, beside `tiny.py`'s: the harness's files copied into
a temporary checkout, these added (no file of the copy is edited), and the
cell run on the CPU through `portbench.run.main` in a subprocess
(`tiny.run_cell`)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.tests import tiny

CELL = "tiny_tb.train"

# a joint vocabulary as the port's tokenizer lays it out: 300 text ids,
# then 40 SMILES ids shifted by 300 ([CLS] 12 and [SEP] 13 among them)
CONFIG = {
    "source": "tiny", "reference": "template", "task": "retro",
    "template_based": True, "unattend_nonbonds": True,
    "encoder": {"vocab_size": 300, "hidden_size": 128,
                "num_hidden_layers": 2, "num_attention_heads": 2,
                "intermediate_size": 256, "max_position_embeddings": 128,
                "type_vocab_size": 2, "hidden_dropout_prob": 0.1,
                "attention_probs_dropout_prob": 0.1, "layer_norm_eps": 1e-12,
                "hidden_act": "gelu", "initializer_range": 0.02,
                "pad_token_id": 0},
    "encoder_ids": {"pad": 0, "cls": 312, "sep": 313, "text_sep": 3,
                    "mask": 4, "first_word": 5, "last_word": 299,
                    "first_atom_token": 315, "vocab_size": 340},
    "num_atom_templates": 10, "num_bond_templates": 6,
    "max_length": 128, "length_buckets": [64, 128],
    "mlm_ratio": 0.15, "mlm_layer": "mlp", "mlm_lambda": 0.1,
    "compute_dtype": "float32", "param_dtype": "float32",
    "lr": 1e-4, "weight_decay": 0.01, "max_grad_norm": 5.0,
    "scheduler": "cosine", "warmup_ratio": 0.0, "num_training_steps": 1000,
    "reduced": []}

TRAIN = {"kind": "train_template", "micro_batches": 2, "micro_batch_size": 4,
         "pool_steps": 3, "checked_steps": 3, "trace_units": 1,
         "prompt": {"length": 128, "neighbors": 2},
         "product": {"atoms": [4, 20], "tokens_per_atom": 2,
                     "rings": [0, 2]},
         "labels": {"atoms": [1, 2], "bonds": [0, 1]},
         "mlm": {"ratio": 0.15, "mean_span": 3, "max_span": 10}}

LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-3}

# the program's step under the (B, L) mask of its real keys (the bond
# mask's diagonal) while the reference keeps the bond mask
MASK_DROPPED = '''
from textreact_tpu_torch.models import encdec
_forward = encdec.TemplateBasedModel.forward
def forward(self, input_ids, attention_mask, *args, **kw):
    if attention_mask.dim() == 3:
        attention_mask = attention_mask.diagonal(dim1=1, dim2=2)
    return _forward(self, input_ids, attention_mask, *args, **kw)
encdec.TemplateBasedModel.forward = forward
'''

# each micro-batch's first half of rows in the program
HALF_BATCH = '''
from textreact_tpu_torch.train import step
_micro = step._AccumStep._micro
def micro(self, batch, denoms):
    half = next(iter(batch.values())).shape[0] // 2
    return _micro(self, {k: v[:half] for k, v in batch.items()}, denoms)
step._AccumStep._micro = micro
'''


def checkout(tmp: Path) -> Path:
    """A copy of BENCHMARK.json and portbench/ with the tiny template cell
    added: it reports what `retro_tb.train` reports."""
    root = tmp / "checkout"
    shutil.copytree(tiny.REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".work",
                                                  ".cache", "out"))
    pb = root / "portbench"
    (pb / "configs" / "tiny_tb.json").write_text(json.dumps(CONFIG))
    (pb / "traffic" / "tiny_templates.json").write_text(json.dumps(TRAIN))
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"numbers": {k: {"limit": v} for k, v in LIMITS.items()}}))
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_tb", "source": "tiny",
                             "file": "portbench/configs/tiny_tb.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny_tb",
                               "traffic": "tiny_templates", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        names = m.get("workloads", [])
        if "retro_tb.train" in names:
            names.append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
