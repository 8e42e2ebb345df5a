"""Evaluation: the RCR and retrosynthesis metrics (twins of
textreact_tpu/evaluation/condition.py and retro.py, over utils/table.py).
The edit ranking and template decoding wait for the template slice."""

from .condition import evaluate_reaction_condition
from .retro import compare_pred_and_gold, evaluate_retrosynthesis

__all__ = ["evaluate_reaction_condition", "evaluate_retrosynthesis",
           "compare_pred_and_gold"]
