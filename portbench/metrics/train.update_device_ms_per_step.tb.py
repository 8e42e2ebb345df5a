"""Device milliseconds under the span `train.update` a template optimizer
step: the gradients' division, norm and clip, AdamW and the gradients
zeroed (spans.device_ms_per)."""

from portbench.spans import device_ms_per


def read(facts):
    return device_ms_per(facts, "train_template", "train.update")
