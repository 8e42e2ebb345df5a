"""A served retro batch's model FLOPs over its untraced wall time, as a
share of the H100's dense bf16 peak (readers.mfu_pct)."""

from portbench.readers import mfu_pct


def read(facts):
    return mfu_pct(facts, "serve")
