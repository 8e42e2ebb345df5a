"""What the per-layer metrics read from a traced run (`run.py` hands them
its facts). Each file under `metrics/` binds one of these to its metric's
name and the kind of cell it reads; a reader that finds nothing to read
returns None, and the metric is left out of the line.

Times per unit (an optimizer step, a served batch) come from two places:
the device's busy time from the traced slice, and the wall time from the
rest of the same run's window, which the profiler does not slow. So an
idle share or a share of the peak is not inflated by the profiler's own
work on the host.
"""

from __future__ import annotations

from portbench.flops import PEAK_FLOPS


def _busy_s_per_unit(facts, kind):
    busy = facts["slice"].busy_us()
    if facts["kind"] != kind or busy <= 0:
        return None
    return busy / 1e6 / facts["units"]


def device_ms_per_unit(facts, kind):
    """The union of the card's kernel and copy intervals over the traced
    slice, in ms a unit."""
    busy = _busy_s_per_unit(facts, kind)
    return None if busy is None else busy * 1e3


def host_calls_per_unit(facts, kind):
    """Host calls that put work on the card (kernel and graph launches,
    copies, memsets) a unit, from the profiler's runtime events."""
    if _busy_s_per_unit(facts, kind) is None:
        return None
    return facts["slice"].launch_calls / facts["units"]


def idle_pct(facts, kind):
    """The share of the untraced window in which the card ran nothing: one
    less the traced busy time a unit over the untraced wall time a unit."""
    busy = _busy_s_per_unit(facts, kind)
    wall = facts["untraced_s_per_unit"]
    if busy is None or not wall:
        return None
    return 100.0 * (1.0 - busy / wall)


def mfu_pct(facts, kind):
    """A unit's model FLOPs (portbench/flops.py) over the untraced wall
    time a unit, as a share of the H100's dense bf16 peak."""
    wall = facts["untraced_s_per_unit"]
    if _busy_s_per_unit(facts, kind) is None or not wall:
        return None
    return 100.0 * facts["model_flops"] / facts["units"] / (wall * PEAK_FLOPS)


def peak_gb(facts, kind):
    """The card's peak of reserved memory over the window
    (torch.cuda.max_memory_reserved: the caching allocator's blocks, the
    CUDA graphs' pools with them), in GB."""
    if facts["kind"] != kind or facts["peak_window_bytes"] <= 0:
        return None
    return facts["peak_window_bytes"] / 1e9


def roofline_pct(facts, bound, kernels):
    """Kernels' share of their roofline: the sum of their bounds
    (`bound_s[bound]`, portbench/flops.py) over the sum of their device
    time in the traced slice."""
    bound_s = facts["bound_s"].get(bound)
    us = facts["slice"].port_device_us()
    spent = sum(us.get(k, 0.0) for k in kernels)
    if not bound_s or spent <= 0:
        return None
    return 100.0 * bound_s / (spent / 1e6)
