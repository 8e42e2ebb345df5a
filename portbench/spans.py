"""The program's named spans in a traced slice: the `record_function`
ranges that the port opens at its layer boundaries while a profiler records
(textreact_tpu_torch/utils/profiling.py `span`), read from the slice's
exported chrome trace (`run.py` writes `out/trace.<cell>.json` before the
readers run).

A kernel, a copy or a memset belongs to every span around the host's
runtime call that launched it: the trace gives both the same correlation
id, and a CUDA graph's replay gives each of its kernels its
`cudaGraphLaunch`'s. A span's count is the number of its ranges in the
slice. A program without spans (an older checkout) gives none, and the
readers of `metrics/` then return None.
"""

from __future__ import annotations

import json
from bisect import bisect_right
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

OUT = Path(__file__).resolve().parent / "out"
SPAN = "user_annotation"                     # a record_function range
LAUNCHERS = ("cuda_runtime", "cuda_driver")  # the host's runtime calls
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals: List[Tuple[float, float]]) -> Tuple[list, list]:
    """The union of intervals as sorted starts and ends."""
    starts, ends = [], []
    for a, b in sorted(intervals):
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return starts, ends


def _inside(union: Tuple[list, list], t: float) -> bool:
    starts, ends = union
    i = bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


class Spans:
    """What one chrome trace says of the spans: `count[name]`, the device
    us under each name (`device_us`), the device us under none
    (`unattributed_us`), and the device events counted (`device_events`).
    Times in microseconds."""

    def __init__(self, events: List[dict]):
        ranges: Dict[str, list] = defaultdict(list)
        launched: Dict[int, float] = {}
        device: List[Tuple[Optional[int], float]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat"), e.get("args", {})
            if cat == SPAN:
                ranges[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
            elif cat in LAUNCHERS and "correlation" in args:
                launched[args["correlation"]] = e["ts"]
            elif cat in DEVICE:
                device.append((args.get("correlation"), e["dur"]))
        self.count = {name: len(r) for name, r in ranges.items()}
        unions = {name: _union(r) for name, r in ranges.items()}
        self.device_events = len(device)
        self.device_us: Dict[str, float] = defaultdict(float)
        self.unattributed_us = 0.0
        for corr, dur in device:
            t = launched.get(corr)
            names = [] if t is None else [
                name for name, u in unions.items() if _inside(u, t)]
            for name in names:
                self.device_us[name] += dur
            if not names:
                self.unattributed_us += dur

    def ms_per(self, name: str) -> Optional[float]:
        """Device ms under `name` over its count; None without the span."""
        n = self.count.get(name, 0)
        return self.device_us[name] / 1e3 / n if n else None


_PARSED: Dict[tuple, Spans] = {}


def parse(path: Path) -> Spans:
    """The spans of one chrome trace, parsed once per file."""
    st = path.stat()
    key = (str(path), st.st_mtime_ns, st.st_size)
    if key not in _PARSED:
        _PARSED[key] = Spans(json.loads(path.read_text())["traceEvents"])
    return _PARSED[key]


def of_slice(facts) -> Optional[Spans]:
    """The spans of the newest trace under OUT, if it is the traced
    slice's: its device events are as many as the slice's kernels. None
    without kernels (a CPU run) or without a trace."""
    if not facts["slice"].kernels:
        return None
    traces = sorted(OUT.glob("trace.*.json"),
                    key=lambda p: p.stat().st_mtime)
    if not traces:
        return None
    spans = parse(traces[-1])
    return (spans if spans.device_events == len(facts["slice"].kernels)
            else None)


def device_ms_per(facts, kind: str, name: str) -> Optional[float]:
    """Device ms under span `name` a span, in a cell of `kind`."""
    if facts["kind"] != kind:
        return None
    spans = of_slice(facts)
    return None if spans is None else spans.ms_per(name)


def program_idle_ms_per_unit(facts, kind: str) -> Optional[float]:
    """The time inside the `serve.batch` spans in which the card ran
    nothing, in ms a unit: each span's length less the union of the
    kernels' intervals inside it, summed. From the slice's own events: the
    host's spans and the card's kernels share the profiler's clock."""
    sl = facts["slice"]
    spans = [(a, b) for n, a, b in sl.host if n == "serve.batch"]
    if facts["kind"] != kind or not spans or not sl.kernels:
        return None
    starts, ends = _union([(a, b) for _, a, b in sl.kernels])
    idle = 0.0
    for lo, hi in spans:
        busy = sum(max(0.0, min(hi, e) - max(lo, s))
                   for s, e in zip(starts, ends) if e > lo and s < hi)
        idle += hi - lo - busy
    return idle / 1e3 / facts["units"]
