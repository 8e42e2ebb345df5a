"""The card's peak of reserved memory over the window of template
optimizer steps, in GB (readers.peak_gb)."""

from portbench.readers import peak_gb


def read(facts):
    return peak_gb(facts, "train_template")
