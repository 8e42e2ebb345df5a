"""The kernel wrappers' launch counters under CUDA graphs, and the capture
that the decode's and the train step's graphs share
(inference/graphs.py, train/graphs.py).

A wrapper adds one to its counter where it launches its kernel (the
packed-mask attention to `MASK_3D_LAUNCHES` beside the forward and
backward counts), and the plain attention path to `PLAIN_MASK_3D_CALLS`
where a 3-D mask sends a call down it (models/layers.py). A capture records the launches without
running them, and a replay runs them without calling the wrappers:
`GraphLaunches` takes back what a capture counted and adds it again at
each replay, so the counters stay equal to the kernels (and plain calls)
the card ran.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch

from ..models import layers
from ..utils.profiling import span
from . import decode_attention, fused_attention, fused_layernorm, topk

# the kernel wrappers' launch counters, and the plain attention path's
# count of calls under a 3-D mask (models/layers.py): (module, name of an
# int or of a dict of ints)
KERNEL_COUNTERS = (
    (fused_attention, "LAUNCHES"), (fused_attention, "BWD_LAUNCHES"),
    (fused_attention, "CAUSAL_LAUNCHES"),
    (fused_attention, "CAUSAL_BWD_LAUNCHES"),
    (fused_attention, "PADDED_LAUNCHES"),
    (fused_attention, "MASK_3D_LAUNCHES"),
    (fused_layernorm, "LAUNCHES"), (fused_layernorm, "BWD_LAUNCHES"),
    (fused_layernorm, "WIDE_LAUNCHES"),
    (fused_layernorm, "WIDE_BWD_LAUNCHES"),
    (topk, "LAUNCHES"), (topk, "LARGE_K_LAUNCHES"),
    (decode_attention, "DECODE_LAUNCHES"),
    (layers, "PLAIN_MASK_3D_CALLS"))


class GraphLaunches:
    """The launches one graph holds, by counter, and their accounting:
    `capturing()` around a capture takes back what the wrappers counted
    while it recorded, `replayed()` after a replay adds it."""

    def __init__(self, counters: Sequence[Tuple[object, str]]
                 = KERNEL_COUNTERS):
        self.counters = counters
        self.per_replay: Dict[tuple, int] = {}

    def _read(self) -> Dict[tuple, int]:
        out = {}
        for owner, name in self.counters:
            value = getattr(owner, name)
            if isinstance(value, dict):
                out.update(((id(owner), name, k), v)
                           for k, v in value.items())
            else:
                out[(id(owner), name, None)] = value
        return out

    def _add(self, delta: Dict[tuple, int], times: int) -> None:
        for owner, name in self.counters:
            value = getattr(owner, name)
            if isinstance(value, dict):
                for k in value:
                    value[k] += times * delta.get((id(owner), name, k), 0)
            else:
                setattr(owner, name,
                        value + times * delta.get((id(owner), name, None), 0))

    @contextmanager
    def capturing(self) -> Iterator[None]:
        before = self._read()
        yield
        self.per_replay = {k: v - before.get(k, 0)
                           for k, v in self._read().items()}
        self._add(self.per_replay, -1)

    def replayed(self, times: int = 1) -> None:
        self._add(self.per_replay, times)


class GraphedPart:
    """One part of a computation as a CUDA graph that draws its memory from
    `pool`. The first call runs `fn` uncaptured on `stream` (the warm-up a
    capture needs: the cuBLAS handle and workspace of the stream, the
    kernels' libraries loaded; its work is real), then captures it; every
    later call replays the graph and counts its launches. `generator`,
    when given, is registered with the graph: each replay then draws from
    the generator's seed and offset as they stand at the replay, not from
    those of the capture. A failed capture or replay raises.
    `capture_ms` is what the capture took, `replays` the replays made.
    Every call runs inside the span `name` (utils/profiling.py), a
    capture inside `graph.capture` too."""

    def __init__(self, pool, stream: torch.cuda.Stream, name: str,
                 generator: Optional[torch.Generator] = None):
        self.pool, self.stream, self.generator = pool, stream, generator
        self.name = name
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches = GraphLaunches()
        self.capture_ms = 0.0
        self.replays = 0

    def __call__(self, fn: Callable[[], None]) -> None:
        with span(self.name):
            if self.graph is not None:
                self.graph.replay()
                self.launches.replayed()
                self.replays += 1
                return
            with span("graph.capture"):
                self._capture(fn)

    def _capture(self, fn: Callable[[], None]) -> None:
        current = torch.cuda.current_stream()
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            fn()
        current.wait_stream(self.stream)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        with self.launches.capturing(), torch.cuda.graph(
                graph, pool=self.pool, stream=self.stream,
                capture_error_mode="thread_local"):
            fn()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.graph = graph
