"""Device milliseconds a template optimizer step
(readers.device_ms_per_unit)."""

from portbench.readers import device_ms_per_unit


def read(facts):
    return device_ms_per_unit(facts, "train_template")
