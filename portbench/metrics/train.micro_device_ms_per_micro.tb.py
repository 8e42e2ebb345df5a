"""Device milliseconds under the span `train.micro` a micro-batch of a
template step: the forward, the backward and the loss sum
(spans.device_ms_per)."""

from portbench.spans import device_ms_per


def read(facts):
    return device_ms_per(facts, "train_template", "train.micro")
