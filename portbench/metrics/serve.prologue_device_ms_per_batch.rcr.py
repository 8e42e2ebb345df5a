"""Device milliseconds under the span `serve.prologue` a served RCR batch:
the encoder, the cache's refill and the beam state's reset
(spans.device_ms_per)."""

from portbench.spans import device_ms_per


def read(facts):
    return device_ms_per(facts, "serve", "serve.prologue")
