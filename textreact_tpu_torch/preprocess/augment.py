"""Training-set augmentation for USPTO-Condition (own copy of
textreact_tpu/preprocess/augment.py over utils/table.py).

Role of reference preprocess/uspto_script/get_aug_condition_data.py:
replicate each train reaction N times with randomized SMILES (fragment
order + atom order), keeping the condition labels.
"""

from __future__ import annotations

import random

from ..data.datasets import random_shuffle_reaction_smiles
from ..utils.table import Table


def augment_condition_train(df: Table, n: int = 5,
                            seed: int = 0,
                            rxn_col: str = "canonical_rxn") -> Table:
    """Each row becomes n rows: the original + (n-1) randomized variants."""
    rng = random.Random(seed)
    rows = []
    for i in range(len(df)):
        row = df.row(i)
        rows.append(row)
        for _ in range(n - 1):
            aug = dict(row)
            aug[rxn_col] = random_shuffle_reaction_smiles(row[rxn_col], rng, p=1.0)
            rows.append(aug)
    return Table.from_records(rows)
