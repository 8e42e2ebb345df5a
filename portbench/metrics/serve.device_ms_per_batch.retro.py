"""Device milliseconds a served retro batch (readers.device_ms_per_unit)."""

from portbench.readers import device_ms_per_unit


def read(facts):
    return device_ms_per_unit(facts, "serve")
