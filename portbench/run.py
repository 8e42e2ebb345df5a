"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell (a `workloads` entry of
BENCHMARK.json) names a configuration (`portbench/configs/<name>.json`)
and a traffic mix (`portbench/traffic/<name>.json`); the mix's `kind`
names the runner (`portbench/kinds/<kind>.py`); each per-layer metric is
read by `portbench/metrics/<metric>.py`; the limits of the comparison are
in `portbench/limits/<cell>.json`. A cell, a mix or a metric is added by
adding files and entries, with no edit here.

A run: set-up (the program's kernels found or built, the model built and
the benchmark's weights loaded, the cell's first steps or warm-up
batches), then a window of `--seconds` on the host's clock, ended by a
synchronize. `--trace 0` reports the cell's end-to-end metrics; `--trace 1`
profiles a fixed steady slice inside the window and reports the per-layer
metrics, the card's busy seconds and the slice's length, and the
breakdown. Then the program's state is freed, and what the timed path
produced is compared with the plain reference (`check.py`). The last line
of standard output is one JSON object; the compared numbers, each beside
its limit, close standard error.

Exits non-zero, printing no result, without a CUDA card (or fewer than the
cell asks for), when a traced slice's kernel count disagrees with the
kernel wrappers' launch counters, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
# the caches of what the program builds, at fixed paths in the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(HERE / ".cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(HERE / ".cache" / "torch_extensions"))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

OUT = HERE / "out"   # the traced slice's chrome trace
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "textreact_tpu")


class RunError(RuntimeError):
    """A run that must end without a result."""


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise RunError(f"BENCHMARK.json has no {what} named {name!r}")


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise RunError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a cell's runner is given."""

    def __init__(self, args, cell: dict, config: dict, device):
        from portbench import traffic
        self.name = cell["name"]
        self.seed = args.seed
        self.config_name = cell["config"]
        path = ROOT / config["file"]
        self.cfg = json.loads(path.read_text())
        self.mix = traffic.load(cell["traffic"])
        self.device = device
        self.log = log


def chip_device(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} are here")
    return torch.device("cuda", 0)


def card_facts(device) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def launch_counters() -> dict:
    """The kernel wrappers' counters, summed by the kinds the trace sees."""
    from textreact_tpu_torch.ops import fused_attention as fa
    from textreact_tpu_torch.ops import fused_layernorm as fl
    padded = fa.PADDED_LAUNCHES
    fwd = (fa.LAUNCHES + fa.CAUSAL_LAUNCHES + padded["fwd"]
           + padded["causal_fwd"])
    bwd = (fa.BWD_LAUNCHES + fa.CAUSAL_BWD_LAUNCHES + padded["bwd"]
           + padded["causal_bwd"])
    return {"attention_fwd": fwd, "attention_bwd_dq": bwd,
            "attention_bwd_dkv": bwd,
            "layernorm_fwd": fl.LAUNCHES + fl.WIDE_LAUNCHES,
            "layernorm_bwd": fl.BWD_LAUNCHES + fl.WIDE_BWD_LAUNCHES}


def run_window(cell, seconds: float, trace: bool, slice_units: int, device):
    """The measured window: units until `seconds` have passed on the host's
    clock, ended by a synchronize. Traced, the units from the second on
    (`slice_units` of them, a synchronize on each side) are profiled, and
    the traced result carries the wall time a unit outside the profiler:
    the window less the time from the synchronize before the slice to the
    profiler's exit, over the units outside the slice."""
    from portbench.trace import Slice
    cuda = device.type == "cuda"
    traced = None
    units = 0
    t0 = time.perf_counter()
    while True:
        if trace and units == 1:
            cell.sync()
            paused = time.perf_counter()
            before = launch_counters()
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            first = cell.done
            prof.__enter__()
            ts = time.perf_counter()
        cell.run_unit()
        units += 1
        if trace and units == 1 + slice_units:
            cell.sync()
            wall = time.perf_counter() - ts
            prof.__exit__(None, None, None)
            after = launch_counters()
            traced = (prof, wall, first, slice_units,
                      {k: after[k] - before[k] for k in after},
                      time.perf_counter() - paused)
        if time.perf_counter() - t0 >= seconds and (
                not trace or traced is not None):
            break
    cell.sync()
    window_s = time.perf_counter() - t0
    if traced is not None:
        prof, wall, first, count, counted, profiled_s = traced
        untraced = None
        if units > count:
            untraced = (window_s - profiled_s) / (units - count)
        traced = (Slice(prof, wall), first, count, counted, untraced)
        OUT.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(OUT / f"trace.{cell.ctx.name}.json"))
    return units, window_s, traced


def check_launches(sl, counted: dict) -> None:
    """The profiler's count of the port's kernels over the slice has to
    equal the wrappers' counters."""
    seen = sl.port_counts()
    wrong = {k: (seen.get(k, 0), v) for k, v in counted.items()
             if seen.get(k, 0) != v}
    if wrong:
        raise RunError("the trace's kernels disagree with the launch "
                       "counters over the slice (seen, counted): "
                       f"{wrong}")


def main(argv=None, device=None) -> dict:
    """One run; returns the result it prints. `device`: run there without
    looking for a card (the tests' CPU runs)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_benchmark()
    cell_spec = find(bench["workloads"], args.workload, "workload")
    config = find(bench["configs"], cell_spec["config"], "configuration")
    if device is None:
        device = chip_device(cell_spec["chips"])
    import torch
    device = torch.device(device)
    from portbench import check, program

    ctx = Context(args, cell_spec, config, device)
    kind = ctx.mix["kind"]
    runner = importlib.import_module(f"portbench.kinds.{kind}")
    limits = check.load_limits(cell_spec["name"])
    trace = bool(args.trace)
    if device.type == "cuda":
        log(f"card: {power_limit()}")
        program.build_kernels()
    cell = runner.Cell(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    # reserved, not allocated: a graph's pool holds its activations
    setup_peak = (torch.cuda.max_memory_reserved(device)
                  if device.type == "cuda" else 0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    slice_units = ctx.mix["trace_units"]
    units, window_s, traced = run_window(cell, args.seconds, trace,
                                         slice_units, device)
    window_peak = (torch.cuda.max_memory_reserved(device)
                   if device.type == "cuda" else 0)
    log(f"{args.workload}: set-up {setup_s!r} s, {units} {cell.unit} in "
        f"{window_s!r} s")

    result_metrics = {}
    breakdown = None
    dev_facts = card_facts(device)
    dev_facts["memory_peak_bytes"] = int(max(setup_peak, window_peak))
    if not trace:
        e2e = cell.end_to_end(units, window_s)
        e2e["setup_s"] = (setup_s, "s")
        for m in bench["end_to_end"]:
            if not reports(m, cell_spec["name"]):
                continue
            if m["name"] not in e2e:
                raise RunError(f"the cell reports no {m['name']}")
            value, unit = e2e[m["name"]]
            result_metrics[m["name"]] = {"value": value, "unit": unit}
    else:
        sl, first, count, counted, untraced = traced
        if device.type == "cuda":
            check_launches(sl, counted)
        facts = cell.slice_facts(first, count)
        facts.update(slice=sl, units=count, unit=cell.unit, kind=kind,
                     peak_window_bytes=window_peak,
                     untraced_s_per_unit=untraced)
        log(f"traced slice: {count} {cell.unit}, {sl.wall_s / count!r} s "
            f"wall and {sl.busy_us() / 1e6 / count!r} s busy a unit; "
            f"untraced {untraced!r} s a unit")
        for m in bench["per_layer"]:
            if not reports(m, cell_spec["name"]):
                continue
            value = load_reader(m["name"])(facts)
            if value is not None:
                result_metrics[m["name"]] = {"value": value,
                                             "unit": m["unit"]}
        dev_facts["busy_s"] = sl.busy_us() / 1e6
        dev_facts["window_s"] = sl.wall_s
        breakdown = {"device_ops": sl.top_ops(), "idle_gaps": sl.idle_gaps()}

    # the program's state goes before the reference runs
    cell.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = {k: v[0] for k, v in cell.check().items()}
    log(f"check took {time.perf_counter() - t_check!r} s")
    correct = check.verdict(numbers, limits)
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package were loaded: "
                       f"{found}")
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    result = {"correct": correct, "attempted": units,
              "failed": 0 if correct else units, "metrics": result_metrics,
              "device": dev_facts}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    log(f"correct: {correct}")
    for line in check.report_lines(numbers, limits):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    try:
        main()
    except RunError as e:
        log(f"error: {e}")
        sys.exit(1)
