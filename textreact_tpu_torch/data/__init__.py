"""Batch building for the port: collation and span MLM (own copies of
textreact_tpu/data/collate.py and mlm.py; numpy only)."""

from .collate import IGNORE_INDEX, Batch, Collator
from .mlm import apply_span_mlm, remap_positions, reorder_masked_first

__all__ = ["IGNORE_INDEX", "Batch", "Collator", "apply_span_mlm",
           "remap_positions", "reorder_masked_first"]
