"""The port's multi-process runtime on the CPU, over gloo: the id-keyed
gathers (tests/test_multihost.py's twin), the trainer started as a world of
ranks, and the gate `entry.dryrun_multichip(4)` with its five legs.

Every world is started by `textreact_tpu_torch.parallel.multihost.spawn`
through a `file://` store in a temporary directory, never a fixed port.
"""

import _torch_threads  # noqa: F401  (before torch runs)
import json
import os

import numpy as np
import pytest
import torch

from test_torch_runtime import TINY_DEC_JSON, TINY_ENC_JSON, _argv
from fixtures import make_condition_data
from textreact_tpu_torch.cli.main import main as port_main
from textreact_tpu_torch.parallel.multihost import spawn

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = "_torch_parallel_worker"


def test_two_process_prediction_gather(tmp_path):
    """Both ranks see the union of nine ids (id 4 repeated on both); rank 0
    alone writes it."""
    spawn(f"{WORKER}:gather_predictions", 2, {"out": str(tmp_path)},
          pythonpath=[HERE])
    files = os.listdir(tmp_path)
    assert files == ["prediction_test_0.json"]
    merged = json.loads((tmp_path / "prediction_test_0.json").read_text())
    assert sorted(int(k) for k in merged) == list(range(9))
    assert merged["7"]["prediction"] == [["tok7a"], ["tok7b"]]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = make_condition_data(str(tmp_path_factory.mktemp("mh_e2e")))
    for name, cfg in (("enc.json", TINY_ENC_JSON), ("dec.json", TINY_DEC_JSON)):
        with open(os.path.join(root, name), "w") as f:
            json.dump(cfg, f)
    return root


def _records(root, save):
    with open(os.path.join(root, save, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# float32: --precision (default bf16) decides the compute dtype
F32 = ("--precision", "32")


def _result(logs):
    line = [x for x in logs[0].splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def one_process(workdir):
    accuracies = port_main(_argv(workdir, "out_one", "--do_train",
                                 "--do_test", "--device", "cpu", *F32))
    return accuracies, _records(workdir, "out_one")


def test_trainer_on_tp2_equals_one_process(workdir, one_process):
    """The whole CLI on dp=1 x tp=2 at the tiny recipe's dropout 0.1, in
    float32: on the CPU each tp rank draws its heads' masks out of the whole
    layer's, so the two ranks train what one process trains: every logged
    loss within 1e-5, the same accuracies; rank 0 alone writes."""
    logs = spawn(f"{WORKER}:trainer_run", 2,
                 {"argv": _argv(workdir, "out_tp2", "--do_train",
                                "--do_test", "--device", "cpu",
                                "--tp_size", "2", *F32)}, pythonpath=[HERE])
    want_acc, want = one_process
    got = _records(workdir, "out_tp2")
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        for key in ("train_loss", "mlm_loss", "val_acc", "val_acc/1"):
            if key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                           atol=1e-6, err_msg=key)
    assert _result(logs) == json.loads(json.dumps(want_acc))
    for name in ("prediction_test_0.json", "prediction_test_1.json"):
        a = json.load(open(os.path.join(workdir, "out_tp2", name)))
        b = json.load(open(os.path.join(workdir, "out_one", name)))
        assert sorted(a) == sorted(b)
        assert all(a[k]["prediction"] == b[k]["prediction"] for k in a)


def test_trainer_on_dp2_runs_and_resumes(workdir, one_process):
    """The whole CLI on dp=2 (each rank loads half of every global batch):
    one metrics log, checkpoints and predictions of every test example from
    rank 0, the accuracy dicts; a longer second run resumes."""
    argv = _argv(workdir, "out_dp2", "--do_train", "--do_test", "--device",
                 "cpu", "--dp_size", "2", *F32)
    logs = spawn(f"{WORKER}:trainer_run", 2, {"argv": argv},
                 pythonpath=[HERE])
    want_acc, _ = one_process
    got_acc = _result(logs)
    assert len(got_acc) == len(want_acc) == 2
    out = os.path.join(workdir, "out_dp2")
    for name in ("best.ckpt", "last.ckpt", "prediction_test_0.json",
                 "prediction_test_1.json"):
        assert os.path.isfile(os.path.join(out, name)), name
    preds = json.load(open(os.path.join(out, "prediction_test_0.json")))
    want = json.load(open(os.path.join(workdir, "out_one",
                                       "prediction_test_0.json")))
    assert sorted(preds) == sorted(want)
    records = _records(workdir, "out_dp2")
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    assert losses and all(np.isfinite(losses))
    assert len([r for r in records if "val_acc" in r]) == 2   # two epochs
    argv = _argv(workdir, "out_dp2", "--do_train", "--device", "cpu",
                 "--dp_size", "2", *F32, epochs=3)
    spawn(f"{WORKER}:trainer_run", 2, {"argv": argv}, pythonpath=[HERE])
    assert any("resumed_at_epoch" in r for r in _records(workdir, "out_dp2"))


def test_dryrun_multichip_passes_its_five_legs(capfd):
    from textreact_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(4, device="cpu")
    lines = [x for x in capfd.readouterr().out.splitlines()
             if x.startswith("dryrun_multichip")]
    assert len(lines) == 5 and all(x.endswith(" ok") for x in lines), lines


def test_entry_gives_the_flagship_forward():
    """`entry()`'s twin of __graft_entry__.py:59-78 at the gate's tiny
    widths on the CPU: logits of the decoder's vocab, finite."""
    from textreact_tpu_torch.entry import entry
    fn, args = entry(device="cpu", tiny=True)
    logits = fn(*args)
    assert logits.shape == (8, 16, 320)
    assert bool(torch.isfinite(logits).all())
