"""The harness on the CPU at a tiny size: the result line, the files found
by name, a cell, a traffic mix and a metric added without an edit, the
planted faults that `correct` must catch, and what the harness and the
reference import."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import check
from portbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "textreact_tpu"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("portbench"))


def _result(root, cell, trace=0, prelude=""):
    rc, out, err = tiny.run_cell(root, cell, trace=trace, prelude=prelude)
    assert rc == 0, err[-3000:]
    return tiny.last_json(out), err


@pytest.mark.parametrize("cell,trace", [("tiny.train", 0), ("tiny.train", 1),
                                        ("tiny.serve", 0), ("tiny.serve", 1)])
def test_result_line(root, cell, trace):
    res, err = _result(root, cell, trace)
    keys = KEYS + (["breakdown"] if trace else []) + ["compared"]
    assert list(res) == keys
    assert res["correct"] is True
    bench = json.loads((root / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    if not trace:
        want = {m["name"] for m in bench[kind]
                if cell in m.get("workloads", [cell])}
        assert set(res["metrics"]) == want
    else:
        assert "tiny.launch_calls" in res["metrics"]
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    # the compared numbers close standard error, each beside its limit
    tail = err.strip().splitlines()[-len(res["compared"]):]
    for name, entry in res["compared"].items():
        assert any(f"check {name}: " in line and "limit" in line
                   for line in tail)
        assert set(entry) == {"value", "limit"}


def test_added_files_edit_nothing(root):
    """The tiny cell's files were added beside the benchmark's: every file
    the copy shares with the repository is unchanged."""
    for path in (root / "portbench").rglob("*"):
        if not path.is_file() or "__pycache__" in path.parts:
            continue
        rel = path.relative_to(root)
        twin = tiny.REPO / rel
        if twin.exists():
            assert twin.read_bytes() == path.read_bytes(), rel


def test_every_cell_found_by_name():
    from portbench import check, traffic
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    pb = tiny.REPO / "portbench"
    configs = {c["name"]: c for c in bench["configs"]}
    for cell in bench["workloads"]:
        cfg = configs[cell["config"]]
        assert (tiny.REPO / cfg["file"]).is_file()
        mix = traffic.load(cell["traffic"])
        assert (pb / "kinds" / f"{mix['kind']}.py").is_file()
        assert check.load_limits(cell["name"])
    for m in bench["per_layer"]:
        assert (pb / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")


# each fault, planted under the timed path, must turn `correct` false
FAULTS = {
    "state_unchanged": ("tiny.train", '''
from textreact_tpu_torch.train import optim
_apply = optim.Optimizer.apply
def apply(self):
    keep = [p.detach().clone() for p in self.params]
    out = _apply(self)
    for p, k in zip(self.params, keep):
        p.data.copy_(k)
    return out
optim.Optimizer.apply = apply
'''),
    "half_batch": ("tiny.train", '''
from textreact_tpu_torch.train import step
_micro = step._AccumStep._micro
def micro(self, batch, denoms):
    half = next(iter(batch.values())).shape[0] // 2
    return _micro(self, {k: v[:half] for k, v in batch.items()}, denoms)
step._AccumStep._micro = micro
'''),
    "token_altered": ("tiny.serve", '''
from textreact_tpu_torch.inference import predictor
_generate = predictor.Generator.generate
def generate(self, batch):
    seqs, scores = _generate(self, batch)
    seqs = seqs.copy()
    seqs[:, 0, 1] = (seqs[:, 0, 1] + 1) % 40
    return seqs, scores
predictor.Generator.generate = generate
'''),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_turns_correct_false(root, fault):
    cell, prelude = FAULTS[fault]
    res, _ = _result(root, cell, prelude=prelude)
    assert res["correct"] is False, res["compared"]


CONTROL = '''
import argparse, importlib, json, sys
sys.path.insert(0, {root!r}); sys.path.append({repo!r})
import torch
from portbench import calibrate, check, run
bench = run.load_benchmark()
spec = run.find(bench["workloads"], {cell!r}, "workload")
config = run.find(bench["configs"], spec["config"], "configuration")
ctx = run.Context(argparse.Namespace(seed=2**31 + 11), spec, config,
                  torch.device("cpu"))
runner = importlib.import_module("portbench.kinds." + ctx.mix["kind"])
readings = (calibrate.train_readings(ctx, runner)
            if ctx.mix["kind"] == "train"
            else calibrate.serve_readings(ctx, runner, 1))
print(json.dumps({{"limits": check.load_limits({cell!r}),
                  "program": readings["program"],
                  "control": readings["control"]}}))
'''


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.serve"])
def test_control_fails_a_limit(root, cell):
    """The reference with float8 products, in the program's place, fails
    one of the cell's limits that the program keeps."""
    code = CONTROL.format(root=str(root), repo=str(tiny.REPO), cell=cell)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    limits = res["limits"]
    assert check.verdict(res["program"], limits), res
    assert not check.verdict(res["control"], limits), res


IMPORTS = '''
import json, sys
sys.path.insert(0, {root!r}); sys.path.append({repo!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
'''


def _top_level(root, body):
    code = IMPORTS.format(root=str(root), repo=str(tiny.REPO), body=body)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax(root):
    """A whole run loads the port and nothing of JAX or the JAX package,
    by whole top-level names (the port's name begins with the JAX
    package's)."""
    names = _top_level(root, '''
from portbench import run
run.main(["--workload", "tiny.train", "--seed", "3", "--seconds", "0.2",
          "--trace", "1"], device="cpu")
''')
    assert "textreact_tpu_torch" in names
    assert not names & FORBIDDEN


def test_reference_loads_no_program(root):
    names = _top_level(root, '''
from portbench.reference import encdec
from portbench import check, flops, traffic, weights
''')
    assert not names & (FORBIDDEN | {"textreact_tpu_torch"})
