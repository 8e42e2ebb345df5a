"""Neighbor-text selection for retrieval augmentation (own copy of
textreact_tpu/data/neighbors.py: pure Python).

Parity: reference textreact/dataset.py:46-80 (deduplicate_neighbors,
get_neighbor_text with gold-neighbor injection, skip-gold filtering and
random subsampling) and dataset.py:212-220 (test_each_neighbor windowing).
"""

from __future__ import annotations

import random as _random
from typing import Dict, List, Optional, Sequence


def deduplicate_by_text(neighbor_ids: Sequence[str], corpus: Dict[str, str]) -> List[str]:
    """Drop neighbors whose corpus text duplicates an earlier neighbor's
    (reference dataset.py:46-56 — order-preserving O(k) via a seen-set;
    the reference's O(k^2) scan computes the same result)."""
    seen = set()
    out: List[str] = []
    for i in neighbor_ids:
        text = corpus[i]
        if text in seen:
            continue
        seen.add(text)
        out.append(i)
    return out


def select_neighbor_texts(
    rxn_id: str,
    neighbor_ids: Sequence[str],
    corpus: Dict[str, str],
    *,
    split: str,
    num_neighbors: int,
    max_num_neighbors: int = 10,
    use_gold_neighbor: bool = False,
    random_neighbor_ratio: float = 0.8,
    skip_gold_neighbor: bool = False,
    rng: Optional[_random.Random] = None,
) -> List[str]:
    """Pick the neighbor paragraphs to append to the encoder input.

    Train: optionally force the gold paragraph first (dataset.py:62-66),
    dedup, truncate to max_num_neighbors, then with probability
    random_neighbor_ratio sample num_neighbors at random, else take the top
    (dataset.py:68-72). Eval: optionally drop any neighbor whose text equals
    the gold text (dataset.py:74-76), dedup, take the top num_neighbors.
    """
    ids = [i for i in neighbor_ids if i in corpus]
    if split == "train":
        rng = rng or _random
        if use_gold_neighbor:
            if rxn_id in ids:
                ids.remove(rxn_id)
            if rxn_id in corpus:
                ids = [rxn_id] + ids
        ids = deduplicate_by_text(ids, corpus)
        texts = [corpus[i] for i in ids[:max_num_neighbors]]
        if rng.random() < random_neighbor_ratio:
            return rng.sample(texts, k=min(num_neighbors, len(texts)))
        return texts[:num_neighbors]
    else:
        if skip_gold_neighbor and rxn_id in corpus:
            gold_text = corpus[rxn_id]
            ids = [i for i in ids if corpus[i] != gold_text]
        ids = deduplicate_by_text(ids, corpus)
        return [corpus[i] for i in ids[:num_neighbors]]


def format_neighbor_text(texts: Sequence[str]) -> str:
    """' (0) text0 (1) text1 ...' (reference dataset.py:79-80)."""
    return "".join(f" ({i}) {t}" for i, t in enumerate(texts))


def window_neighbor_texts(neighbor_ids: Sequence[str], corpus: Dict[str, str],
                          nn_offset: int, num_neighbors: int) -> List[str]:
    """test_each_neighbor mode: the nn_offset-th window of neighbors
    (reference dataset.py:213-219 — note: no corpus-membership filter)."""
    return [corpus[i] for i in neighbor_ids[nn_offset:nn_offset + num_neighbors]]
