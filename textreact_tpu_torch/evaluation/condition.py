"""RCR metric: top-k exact 5-tuple condition match (own copy of
textreact_tpu/evaluation/condition.py over utils/table.py).

Bit-faithful port target: reference textreact/evaluate.py:15-24
(evaluate_reaction_condition): prediction i hits iff the decoded token list
equals [catalyst1, solvent1, solvent2, reagent1, reagent2] exactly; report
top-k accuracy for k in {1,3,5,10,15} over len(data_df).
"""

from __future__ import annotations

from typing import Any, Dict

from ..data.corpus import CONDITION_COLS
from ..utils.table import Table

TOP_KS = (1, 3, 5, 10, 15)


def evaluate_reaction_condition(prediction: Dict[int, Dict[str, Any]],
                                data_df: Table) -> Dict[int, float]:
    cnt = {x: 0 for x in TOP_KS}
    for i, output in prediction.items():
        row = data_df.row(int(i))
        # read verbatim: a NaN cell equals no predicted string
        label = [row[c] for c in CONDITION_COLS]
        hit_map = [list(pred) == label for pred in output["prediction"]]
        for x in cnt:
            cnt[x] += any(hit_map[:x])
    num_example = len(data_df)
    return {x: cnt[x] / num_example for x in cnt}
