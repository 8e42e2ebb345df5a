"""Frequency-prior dummy baseline for RCR (own copy of
textreact_tpu/preprocess/frequency_baseline.py over utils/table.py).

Role of reference preprocess/uspto_script/get_dummy_model_results.py: score
a fixed list of globally most frequent condition tuples against the test
set — a sanity floor for the trained predictor and a check of the metric
code.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence

from ..data.corpus import CONDITION_COLS
from ..evaluation.condition import evaluate_reaction_condition
from ..utils.table import Table


def top_condition_tuples(train_df: Table, k: int = 15) -> List[List[str]]:
    """Most frequent 5-slot condition tuples in the training data."""
    counter = Counter(zip(*(train_df[c] for c in CONDITION_COLS)))
    return [list(t) for t, _ in counter.most_common(k)]


def dummy_predictions(test_df: Table, tuples: Sequence[Sequence[str]]
                      ) -> Dict[int, Dict]:
    """Every example predicts the same ranked frequency-prior list."""
    preds = [list(t) for t in tuples]
    return {i: {"prediction": preds, "score": [0.0] * len(preds)}
            for i in range(len(test_df))}


def frequency_baseline_accuracy(train_df: Table,
                                test_df: Table,
                                k: int = 15) -> Dict[int, float]:
    return evaluate_reaction_condition(
        dummy_predictions(test_df, top_condition_tuples(train_df, k)), test_df)
