"""Device milliseconds under the span `serve.step` a decode step the card
ran, in served RCR batches (spans.device_ms_per)."""

from portbench.spans import device_ms_per


def read(facts):
    return device_ms_per(facts, "serve", "serve.step")
