"""The template step's model FLOPs (portbench/flops_template.py) over its
untraced wall time, as a share of the H100's dense bf16 peak
(readers.mfu_pct)."""

from portbench.readers import mfu_pct


def read(facts):
    return mfu_pct(facts, "train_template")
