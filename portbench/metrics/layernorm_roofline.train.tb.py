"""The fused residual LayerNorm kernels' share of their roofline in the
template step, forward and backward (readers.roofline_pct)."""

from portbench.readers import roofline_pct


def read(facts):
    if facts["kind"] != "train_template":
        return None
    return roofline_pct(facts, "layernorm",
                        ("layernorm_fwd", "layernorm_bwd"))
