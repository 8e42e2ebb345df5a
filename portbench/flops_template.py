"""The yardstick's arithmetic of the template-based train step (the
`train_template` cells), as `flops.py` counts the encoder-decoder's, from
the configuration's sizes and the traffic's shapes alone.

Model FLOPs: every matrix product of the model on the real tokens, with
each query's attention over the keys its example's (L, L) bond mask
admits (the row's ones); the MLM head on the labelled positions; the atom
head on the real atoms and the bond head in its published form,
W [h_i; h_j] + b, on the real bonds. A product of m x k by k x n is
2 m k n; training counts the forward three times.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import flops


def forward_flops(step_mb: Dict[str, np.ndarray], cfg: dict) -> float:
    """Forward FLOPs of one micro-batch (arrays without the micro-batch
    axis)."""
    enc = cfg["encoder"]
    d, f = enc["hidden_size"], enc["intermediate_size"]
    V = cfg["encoder_ids"]["vocab_size"]
    total = 0.0
    for mask in step_mb["attention_mask"]:
        # the real tokens are the rows that admit a key
        n_tok, pairs = float((mask.sum(-1) > 0).sum()), float(mask.sum())
        total += enc["num_hidden_layers"] * (
            n_tok * (8 * d * d + 4 * d * f) + 4 * d * pairs)
    if "mlm_labels" in step_mb:
        total += flops.mlm_flops(int((step_mb["mlm_labels"] != -100).sum()),
                                 dict(enc, vocab_size=V))
    atoms = int((step_mb["atom_template_labels"] != -100).sum())
    bonds = int((step_mb["bond_template_labels"] != -100).sum())
    total += atoms * 2 * d * (cfg["num_atom_templates"] + 1)
    total += bonds * 2 * (2 * d) * (cfg["num_bond_templates"] + 1)
    return total


def train_step_flops(step: Dict[str, np.ndarray], cfg: dict) -> float:
    """Model FLOPs of one optimizer step over stacked micro-batches."""
    n_micro = step["input_ids"].shape[0]
    return 3.0 * sum(forward_flops({k: v[i] for k, v in step.items()}, cfg)
                     for i in range(n_micro))


def layernorm_bound_s(step: Dict[str, np.ndarray], cfg: dict) -> float:
    """Bound seconds of the step's residual LayerNorm kernels, forward and
    backward: two a layer over every row of a micro-batch."""
    enc = cfg["encoder"]
    n_micro, B, L = step["input_ids"].shape
    b = flops.layernorm_bounds(B * L, enc["hidden_size"])
    return n_micro * 2 * enc["num_hidden_layers"] * (b["fwd"] + b["bwd"])
