"""The share of the untraced window of template optimizer steps in which
the card ran nothing (readers.idle_pct)."""

from portbench.readers import idle_pct


def read(facts):
    return idle_pct(facts, "train_template")
