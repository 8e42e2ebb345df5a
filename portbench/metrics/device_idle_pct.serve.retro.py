"""The share of the untraced window of served retro batches in which the
card ran nothing (readers.idle_pct)."""

from portbench.readers import idle_pct


def read(facts):
    return idle_pct(facts, "serve")
