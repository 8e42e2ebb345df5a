"""Host calls that put work on the card a template optimizer step
(readers.host_calls_per_unit)."""

from portbench.readers import host_calls_per_unit


def read(facts):
    return host_calls_per_unit(facts, "train_template")
