"""Profiling hooks: torch.profiler traces, the program's named spans and
per-step wall timing (twin of textreact_tpu/utils/profiling.py).

`with trace(dir):` records the host and, where there is a card, the device
side of what runs inside it, and writes a Chrome trace (`trace.json`,
viewable in Perfetto) and a table of the kernels by device time
(`kernels.txt`) into `dir`; StepTimer reports steps/s.

`with span(name):` marks a layer boundary of the program (the serving,
train and eval steps' parts, see SPANS) as a `record_function` range while
a torch profiler records, whoever started it (`trace`, the benchmark's
traced slice, a tool); otherwise it is one shared null context, and costs
a flag read. A range is a host event on the profiler's clock: the device
time of a kernel or a copy belongs to the ranges around the runtime call
that launched it (for a CUDA graph's replay, its `cudaGraphLaunch`), which
the trace links by correlation id. No range opens inside a captured
function except the decode's four parts, the plain attention path, the
packed-mask route and the template heads, which there mark the capture's
host side only. A range opens around a forward: the backward that autograd
runs for it lies outside it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import ContextManager, Iterator, Optional

import torch
import torch.autograd.profiler as autograd_profiler

# every span the program opens, and what it covers
SPANS = {
    "serve.batch": "one Generator.generate call, both routes",
    "serve.stage": "a batch's inputs into the device buffers",
    "serve.prologue": "encoder, cache refill or init, beam state reset",
    "serve.step": "one decode step (a graph's replay or the loop's body)",
    "serve.stop_read": "the stop flag's copy, its event and the wait",
    "serve.finalize": "the beams' finalize and the copies back enqueued",
    "serve.readback": "the wait for the card and the numpy copies",
    "train.step": "one optimizer step, both step kinds",
    "train.stage": "one micro-batch's inputs staged and copied",
    "train.micro": "one micro-batch: forward, backward, loss sum",
    "train.update": "gradients divided, norm, clip, AdamW, zeroed",
    "train.loader_wait": "the trainer's wait for its next loader batch",
    "eval.forward": "the eval step's forward",
    "graph.capture": "a graphed part's warm-up run and its capture",
    "beam.ancestor_bias": "the beams' ancestry bias (uncaptured decode)",
    "decode.self_attention": "a decoder layer's cached self-attention",
    "decode.cross_attention": "a decoder layer's cross-attention",
    "decode.products": "one of the decode attention's batched products",
    "attention.plain": "a full-sequence attention's plain path (forward)",
    "attention.mask_3d": "an attention's fused route under a packed 3-D "
                         "mask (forward: draw, keep bits, kernel)",
    "template.head": "the atom-state gather and the three template heads",
}

_OFF = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """A `record_function(name)` range while a torch profiler records,
    else a null context. The gate is the profiler's own flag, read at each
    call (`record_function` costs some 10 us a call even with no profiler
    running)."""
    if autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    sort_by = ("self_device_time_total" if torch.cuda.is_available()
               else "self_cpu_time_total")
    with open(os.path.join(log_dir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort_by, row_limit=50))


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.start: Optional[float] = None

    def tick(self) -> None:
        self.count += 1
        if self.count == self.warmup:
            self.start = time.perf_counter()

    @property
    def steps_per_sec(self) -> float:
        if self.start is None or self.count <= self.warmup:
            return 0.0
        return (self.count - self.warmup) / (time.perf_counter() - self.start)
