"""The fused attention kernels' share of their roofline in training,
forward and backward (readers.roofline_pct)."""

from portbench.readers import roofline_pct


def read(facts):
    return roofline_pct(facts, "attention", (
        "attention_fwd", "attention_bwd_dq", "attention_bwd_dkv"))
