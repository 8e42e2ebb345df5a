"""USPTO-Condition dataset splitting + vocabulary generation (own copy of
textreact_tpu/preprocess/condition_splits.py over utils/table.py).

Roles of reference preprocess/uspto_script/4.0.split_train_val_test.py
(random split with no canonical-rxn overlap between train and val/test, and
the patent-year time split) and 5.0.convert_context_tokens.py (condition
vocabulary file generation).
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Dict, List, Tuple

from ..utils.table import Table, shuffled_positions

CONDITION_COLS = ["catalyst1", "solvent1", "solvent2", "reagent1", "reagent2"]
SPECIALS = ["[PAD]", "[BOS]", "[EOS]", "[MASK]", "[UNK]", "[SEP]"]


def random_split_no_overlap(df: Table, frac=(0.8, 0.1, 0.1),
                            seed: int = 123) -> Table:
    """Shuffle, then assign each unique canonical_rxn wholly to one split:
    singleton reactions fill test then val; duplicated reactions go to train
    (reference 4.0.split_train_val_test.py:37-58). Adds a 'dataset' column.
    The rows come out in the shuffled order; a row's label is its position
    in `df`, as `df.sample(frac=1)` keeps the index."""
    rng = random.Random(seed)
    order = shuffled_positions(len(df), seed)
    sample = df.select(order)
    rxn_to_rows = defaultdict(list)
    for idx, rxn in zip(order, sample["canonical_rxn"]):
        rxn_to_rows[rxn].append(idx)
    items = list(rxn_to_rows.items())
    rng.shuffle(items)
    n = len(sample)
    train_idx, val_idx, test_idx = [], [], []
    for _, rows in items:
        if len(rows) == 1:
            if len(test_idx) < frac[2] * n:
                test_idx += rows
            elif len(val_idx) < frac[1] * n:
                val_idx += rows
            else:
                train_idx += rows
        else:
            train_idx += rows
    dataset = {}
    for name, rows in (("train", train_idx), ("val", val_idx),
                       ("test", test_idx)):
        dataset.update(dict.fromkeys(rows, name))
    sample["dataset"] = [dataset[idx] for idx in order]
    return sample


def time_split(df: Table, patent_year: Dict[str, int],
               test_years=(2016,), val_years=(2015,)
               ) -> Tuple[Table, Table, Table]:
    """Split by source-patent year (reference 4.0:62-80)."""
    train_idx, val_idx, test_idx = [], [], []
    for pos, source in enumerate(df["source"]):
        year = patent_year.get(source, -1)
        if year in test_years:
            test_idx.append(pos)
        elif year in val_years:
            val_idx.append(pos)
        else:
            train_idx.append(pos)
    return df.select(train_idx), df.select(val_idx), df.select(test_idx)


def condition_vocab(df: Table) -> List[str]:
    """Specials + sorted unique condition strings over the 5 slots
    (reference 5.0.convert_context_tokens.py:22-30)."""
    uniq = set()
    for col in CONDITION_COLS:
        uniq.update(str(v) if not isinstance(v, str) else v for v in df[col])
    return SPECIALS + sorted(uniq)


def write_vocab(vocab: List[str], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab))
