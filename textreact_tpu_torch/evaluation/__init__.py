"""Evaluation: the RCR and retrosynthesis metrics, the template edit
ranking and the template decode (twins of textreact_tpu/evaluation, over
utils/table.py)."""

from .condition import evaluate_reaction_condition
from .edit_rank import device_topk_edits, edits_from_topk, rank_edits
from .retro import compare_pred_and_gold, evaluate_retrosynthesis

__all__ = ["evaluate_reaction_condition", "evaluate_retrosynthesis",
           "compare_pred_and_gold", "rank_edits", "device_topk_edits",
           "edits_from_topk"]
