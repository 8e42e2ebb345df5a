"""The fused residual LayerNorm kernels' share of their roofline in
training, forward and backward (readers.roofline_pct)."""

from portbench.readers import roofline_pct


def read(facts):
    return roofline_pct(facts, "layernorm",
                        ("layernorm_fwd", "layernorm_bwd"))
