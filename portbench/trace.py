"""Reading a torch.profiler trace of a window's slice: the kernels the card
ran, the time it was busy (the union of their intervals), the host's
launch calls, the kernels of the port by kind, the top device operations
and the longest idle gaps with what the host was doing in them.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import torch

# the host calls that put work on the card
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")
# the port's kernels by kind: name fragment, kind
PORT_KERNELS = (("attention_fwd", "attention_fwd"),
                ("attention_bwd_dq", "attention_bwd_dq"),
                ("attention_bwd_dkv", "attention_bwd_dkv"),
                ("residual_layernorm_fwd", "layernorm_fwd"),
                ("residual_layernorm_bwd", "layernorm_bwd"))


def port_kind(name: str) -> str:
    for fragment, kind in PORT_KERNELS:
        if fragment in name:
            return kind
    return ""


class Slice:
    """The events of one profiled slice. Times in microseconds."""

    def __init__(self, prof, wall_s: float):
        events = prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        host = [ev for ev in events if ev.device_type != cuda]
        host_names = {ev.name for ev in host}
        # ranges the host opened are mirrored on the device's track: they
        # are no kernels
        self.kernels: List[Tuple[str, float, float]] = [
            (ev.name, ev.time_range.start, ev.time_range.end)
            for ev in events if ev.device_type == cuda
            and ev.name not in host_names]
        self.host = [(ev.name, ev.time_range.start, ev.time_range.end)
                     for ev in host]
        self.wall_s = wall_s
        self.launch_calls = sum(ev.name in HOST_LAUNCH_CALLS for ev in host)

    def busy_us(self) -> float:
        """Length of the union of the kernels' intervals."""
        total, start, end = 0.0, None, None
        for a, b, in sorted((a, b) for _, a, b in self.kernels):
            if end is None or a > end:
                if end is not None:
                    total += end - start
                start, end = a, b
            else:
                end = max(end, b)
        if end is not None:
            total += end - start
        return total

    def port_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = defaultdict(int)
        for name, _, _ in self.kernels:
            kind = port_kind(name)
            if kind:
                out[kind] += 1
        return dict(out)

    def port_device_us(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, a, b in self.kernels:
            kind = port_kind(name)
            if kind:
                out[kind] += b - a
        return dict(out)

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for name, a, b in self.kernels:
            by[name[:120]] += b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us / 1e6] for name, us in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The n longest stretches with no kernel on the card between the
        first kernel and the last, each named by the host call that was
        running at its midpoint (the innermost one)."""
        spans = sorted((a, b) for _, a, b in self.kernels)
        gaps, end = [], None
        for a, b in spans:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for lo, hi in gaps[:n]:
            mid = (lo + hi) / 2
            inner = [(b - a, name) for name, a, b in self.host
                     if a <= mid <= b]
            what = min(inner)[1] if inner else "no host call"
            out.append([what[:120], (hi - lo) / 1e6])
        return out
