"""Span MLM masking with masked-token-first reordering (own copy of
textreact_tpu/data/mlm.py).

Parity: reference textreact/dataset.py:82-122 (apply_mlm /
_reorder_masked_sequence): Poisson(λ=3) span lengths until ~mlm_ratio of
tokens are masked; the masked positions are then moved to the FRONT of the
sequence, with position_ids recording original positions so the encoder's
position embeddings are unchanged. Keeping the masked block contiguous at
the front lets the MLM head run on a prefix slice (the reference relies on
the same trick to truncate encoder states, main.py:158-162).
"""

from __future__ import annotations

import random as _random
from typing import Dict, List, Optional, Tuple

import numpy as np


def apply_span_mlm(
    input_ids: List[int],
    mask_token_id: int,
    mlm_ratio: float,
    rng: Optional[_random.Random] = None,
    np_rng: Optional[np.random.Generator] = None,
    max_tries: int = 100,
    max_span: int = 10,
) -> Tuple[List[int], List[int], List[int]]:
    """Returns (reordered_input_ids, position_ids, mlm_labels_masked).

    mlm_labels_masked has one entry per masked position (aligned with the
    masked-first prefix); unmasked positions carry no label.
    """
    rng = rng or _random
    np_rng = np_rng or np.random.default_rng(rng.randrange(2**31))
    origin_ids = list(input_ids)
    ids = list(input_ids)
    n = len(ids)
    labels = [-100] * n
    num_to_mask = int(n * mlm_ratio)
    for _ in range(max_tries):
        k = int(np_rng.poisson(lam=3))
        if k == 0 or k > min(max_span, n) or k > num_to_mask:
            continue
        start = rng.randrange(n - k)
        end = start + k
        span = origin_ids[start:end]
        ids[start:end] = [mask_token_id] * k
        labels[start:end] = span
        num_to_mask -= k
        if num_to_mask < 0:
            break
    return reorder_masked_first(ids, labels, mask_token_id)


def reorder_masked_first(
    input_ids: List[int], mlm_labels: List[int], mask_token_id: int
) -> Tuple[List[int], List[int], List[int]]:
    """Move masked tokens to the front; position_ids keep original indices
    (reference dataset.py:109-122)."""
    ids_masked, ids_unmasked = [], []
    pos_masked, pos_unmasked = [], []
    labels_masked = []
    for i, tok in enumerate(input_ids):
        if tok == mask_token_id:
            ids_masked.append(tok)
            labels_masked.append(mlm_labels[i])
            pos_masked.append(i)
        else:
            ids_unmasked.append(tok)
            pos_unmasked.append(i)
    return (ids_masked + ids_unmasked, pos_masked + pos_unmasked, labels_masked)


def remap_positions(position_ids: List[int], old_positions: List[int]) -> List[int]:
    """old position -> new position map applied to a list of old positions
    (for atom_indices after MLM reorder, reference dataset.py:103-105)."""
    old2new: Dict[int, int] = {old: new for new, old in enumerate(position_ids)}
    return [old2new[p] for p in old_positions]
