"""The benchmark's readers of the program's spans (portbench/spans.py and
the five metrics under portbench/metrics/ that use it), on hand-made
traces.

A small chrome trace with host spans, runtime calls with correlation ids
(a kernel launch, a graph launch, a copy, and a launch outside every span),
kernels, a copy and a memset gives each span's count and device time, and
the device time under no span. A slice-like object gives the program's
idle time inside `serve.batch`. Each reader returns None where there is
nothing to read: no kernels (a CPU run), another kind of cell, a trace
that is not the slice's, a program without spans.
"""

import importlib.util
import json
import os
from pathlib import Path

import pytest

from portbench import spans

METRICS = Path(spans.__file__).resolve().parent / "metrics"
NEW = ("serve.prologue_device_ms_per_batch.rcr",
       "serve.decode_device_ms_per_step.rcr",
       "serve.decode_device_ms_per_step.retro",
       "serve.program_idle_ms_per_batch.rcr",
       "train.update_device_ms_per_step")


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1,
            "ts": ts, "dur": dur, "args": args}


def _trace():
    """One batch of a prologue and two steps (all us): the prologue's
    graph launch (correlation 1) runs two kernels, each step's (2, 3) one
    kernel and a memset; the readback's copy (4); a kernel launched
    between batches (5), under no span."""
    return [
        _x("user_annotation", "serve.batch", 0, 100),
        _x("user_annotation", "serve.prologue", 1, 10),
        _x("user_annotation", "serve.step", 20, 10),
        _x("user_annotation", "serve.step", 40, 10),
        _x("user_annotation", "serve.readback", 80, 15),
        _x("cuda_runtime", "cudaGraphLaunch", 2, 3, correlation=1),
        _x("cuda_runtime", "cudaGraphLaunch", 21, 3, correlation=2),
        _x("cuda_driver", "cuLaunchKernel", 41, 3, correlation=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 81, 2, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 105, 2, correlation=5),
        _x("kernel", "encoder", 5, 6, correlation=1),
        _x("kernel", "refill", 11, 4, correlation=1),
        _x("kernel", "step", 25, 3, correlation=2),
        _x("gpu_memset", "Memset", 28, 1, correlation=2),
        _x("kernel", "step", 45, 3, correlation=3),
        _x("gpu_memcpy", "Memcpy DtoH", 83, 2, correlation=4),
        _x("kernel", "between", 108, 7, correlation=5),
        # flow arrows and the device track's mirrors of the ranges are no
        # device work
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "ts": 2},
        _x("gpu_user_annotation", "serve.step", 25, 4),
    ]


def test_spans_of_a_hand_made_trace():
    got = spans.Spans(_trace())
    assert got.count == {"serve.batch": 1, "serve.prologue": 1,
                         "serve.step": 2, "serve.readback": 1}
    assert got.device_events == 7
    assert got.device_us["serve.prologue"] == 10.0
    assert got.device_us["serve.step"] == 7.0
    assert got.device_us["serve.readback"] == 2.0
    # nested spans each hold what they launched
    assert got.device_us["serve.batch"] == 19.0
    assert got.unattributed_us == 7.0
    assert got.ms_per("serve.step") == pytest.approx(3.5e-3)
    assert got.ms_per("train.update") is None


class _Slice:
    def __init__(self, kernels, host):
        self.kernels, self.host = kernels, host


def _facts(kind, kernels=7, host=(), units=1):
    sl = _Slice([("k", float(i), float(i) + 1) for i in range(kernels)],
                list(host))
    return {"slice": sl, "kind": kind, "units": units}


@pytest.fixture
def out(tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "OUT", tmp_path)
    return tmp_path


def _read(metric, facts):
    spec = importlib.util.spec_from_file_location(
        "metric_" + metric.replace(".", "_"), METRICS / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(facts)


def test_the_readers_read_the_newest_trace_of_the_slice(out):
    (out / "trace.old.json").write_text(json.dumps({"traceEvents": []}))
    os.utime(out / "trace.old.json", (1, 1))
    (out / "trace.rcr.serve.json").write_text(
        json.dumps({"traceEvents": _trace()}))
    facts = _facts("serve")
    assert _read("serve.prologue_device_ms_per_batch.rcr",
                 facts) == pytest.approx(10e-3)
    for metric in ("serve.decode_device_ms_per_step.rcr",
                   "serve.decode_device_ms_per_step.retro"):
        assert _read(metric, facts) == pytest.approx(3.5e-3)
    # a serving trace has no update; a training cell reads no serve span
    assert _read("train.update_device_ms_per_step", _facts("train")) is None
    assert _read("serve.decode_device_ms_per_step.rcr",
                 _facts("train")) is None
    # a slice of another kernel count: the trace is not the slice's
    assert _read("serve.decode_device_ms_per_step.rcr",
                 _facts("serve", kernels=6)) is None
    # no kernels: a CPU run
    assert _read("serve.decode_device_ms_per_step.rcr",
                 _facts("serve", kernels=0)) is None


def test_the_update_reader_and_a_program_without_spans(out):
    events = [_x("user_annotation", "train.step", 0, 50),
              _x("user_annotation", "train.update", 30, 10),
              _x("cuda_runtime", "cudaGraphLaunch", 31, 2, correlation=9),
              _x("kernel", "adamw", 35, 4, correlation=9)]
    (out / "trace.rcr.train.json").write_text(
        json.dumps({"traceEvents": events}))
    assert _read("train.update_device_ms_per_step",
                 _facts("train", kernels=1)) == pytest.approx(4e-3)
    # the same trace with no spans, as an older program writes it
    bare = [e for e in events if e["cat"] != "user_annotation"]
    (out / "trace.rcr.train.json").write_text(
        json.dumps({"traceEvents": bare}))
    assert _read("train.update_device_ms_per_step",
                 _facts("train", kernels=1)) is None


def test_program_idle_inside_the_batch_spans():
    """Two batches of 10 and 20 us; kernels busy 2-4 and 3-6 (one union of
    4 us) in the first, 12-15 in the second, and one between them that no
    batch holds."""
    sl = _Slice([("a", 2.0, 4.0), ("b", 3.0, 6.0), ("c", 10.5, 11.0),
                 ("d", 12.0, 15.0)],
                [("serve.batch", 0.0, 10.0), ("serve.stage", 0.0, 1.0),
                 ("serve.batch", 11.0, 31.0)])
    facts = {"slice": sl, "kind": "serve", "units": 2}
    idle_us = (10 - 4) + (20 - 3)
    assert _read("serve.program_idle_ms_per_batch.rcr",
                 facts) == pytest.approx(idle_us / 1e3 / 2)
    assert _read("serve.program_idle_ms_per_batch.rcr",
                 dict(facts, kind="train")) is None
    no_kernels = {"slice": _Slice([], sl.host), "kind": "serve", "units": 2}
    assert _read("serve.program_idle_ms_per_batch.rcr", no_kernels) is None
    no_spans = {"slice": _Slice(sl.kernels, []), "kind": "serve", "units": 2}
    assert _read("serve.program_idle_ms_per_batch.rcr", no_spans) is None


def test_benchmark_names_the_five_readers():
    bench = json.loads((METRICS.parent.parent / "BENCHMARK.json").read_text())
    named = {m["name"]: m for m in bench["per_layer"]}
    for metric in NEW:
        assert (METRICS / f"{metric}.py").is_file()
        assert named[metric]["source"] == "device_trace"
        assert named[metric]["unit"] == "ms"
