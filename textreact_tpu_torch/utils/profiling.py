"""Profiling hooks: torch.profiler traces + per-step wall timing (twin of
textreact_tpu/utils/profiling.py).

`with trace(dir):` records the host and, where there is a card, the device
side of what runs inside it, and writes a Chrome trace (`trace.json`,
viewable in Perfetto) and a table of the kernels by device time
(`kernels.txt`) into `dir`; StepTimer reports steps/s.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


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
