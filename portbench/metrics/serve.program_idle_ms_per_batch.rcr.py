"""Milliseconds a served RCR batch in which the card ran nothing while the
program was inside `Generator.generate` (the span `serve.batch`)
(spans.program_idle_ms_per_unit)."""

from portbench.spans import program_idle_ms_per_unit


def read(facts):
    return program_idle_ms_per_unit(facts, "serve")
