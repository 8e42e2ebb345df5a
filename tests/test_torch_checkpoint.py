"""The port's checkpoints on the CPU: the best/last policy cases of
tests/test_checkpoint_policy.py, the copy that an in-place update cannot
reach, a SIGKILL/resume run in the role of tests/test_crash_resume.py, and
the gradients of a rematerialised model at p = 0.1."""

import _torch_threads  # noqa: F401  (before torch runs)
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from fixtures import make_condition_data
from textreact_tpu_torch.config import ExperimentConfig
from textreact_tpu_torch.models import (EncoderDecoder, TransformerConfig)
from textreact_tpu_torch.models.factory import init_weights
from textreact_tpu_torch.train import (CheckpointManager, TrainState,
                                       make_optimizer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(v, steps=0):
    """A two-parameter state whose weights are all `v`, after `steps`
    optimizer updates."""
    module = torch.nn.Linear(4, 2)
    with torch.no_grad():
        module.weight.fill_(float(v))
        module.bias.fill_(float(v))
    optimizer = make_optimizer(ExperimentConfig(lr=0.1), 10,
                               module.named_parameters())
    state = TrainState.create(module, optimizer)
    for _ in range(steps):
        optimizer.zero_grad()
        module(torch.ones(3, 4)).sum().backward()
        optimizer.update()
        state.step += 1
    return state


def test_val_acc_mode_keeps_max(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "val_acc")
    best = mgr.save_eval(_state(1), 0.5, None, epoch=0)
    assert best == 0.5
    best = mgr.save_eval(_state(2), 0.4, best, epoch=1)   # worse: best kept
    assert best == 0.5
    best = mgr.save_eval(_state(3), 0.7, best, epoch=2)   # better: replaced
    assert best == 0.7
    restored, meta = mgr.restore("best", _state(0), device="cpu")
    assert float(restored.module.weight[0, 0]) == 3.0
    assert meta["epoch"] == 2 and meta["val_acc"] == 0.7
    # 'last' always tracks the most recent eval
    _, last_meta = mgr.restore("last", _state(0), device="cpu")
    assert last_meta["epoch"] == 2


def test_val_loss_mode_keeps_min(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "val_loss")
    assert mgr.is_improvement(1.0, None)
    assert mgr.is_improvement(0.5, 1.0)
    assert not mgr.is_improvement(2.0, 1.0)
    best = mgr.save_eval(_state(1), 1.0, None, epoch=0)
    best = mgr.save_eval(_state(2), 2.0, best, epoch=1)
    assert best == 1.0
    restored, meta = mgr.restore("best", _state(0), device="cpu")
    assert float(restored.module.bias[0]) == 1.0 and meta["epoch"] == 0


def test_clear_removes_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "val_acc")
    mgr.save("best", _state(1), {"epoch": 0})
    assert mgr.exists("best")
    (tmp_path / "stale.ckpt.tmp").write_text("half a write")
    (tmp_path / "metrics.jsonl").write_text("{}\n")
    mgr.clear()
    assert not mgr.exists("best")
    assert os.listdir(tmp_path) == ["metrics.jsonl"]


@pytest.mark.parametrize("async_save", [True, False])
def test_save_publishes_atomically(tmp_path, async_save):
    """A save stays in <name>.ckpt.tmp until its write is complete and is
    published by rename, meta last; the published one restores bit-exactly,
    with the optimizer's moments, its update count and the step."""
    state = _state(1, steps=3)
    want = {k: v.clone() for k, v in state.module.state_dict().items()}
    moments = [s["exp_avg"].clone()
               for s in state.optimizer.adamw.state.values()]
    mgr = CheckpointManager(str(tmp_path), "val_acc", async_save=async_save)
    mgr.save("last", state, {"epoch": 1})
    assert mgr.exists("last")
    assert not os.path.exists(tmp_path / "last.ckpt.tmp")
    assert os.path.isfile(tmp_path / "last.ckpt")
    got, meta = mgr.restore("last", _state(0), device="cpu")
    assert meta == {"epoch": 1}
    assert got.step == 3 and got.optimizer.count == 3
    for k, v in got.module.state_dict().items():
        assert torch.equal(v, want[k])
    for s, m in zip(got.optimizer.adamw.state.values(), moments):
        assert torch.equal(s["exp_avg"], m) and float(s["step"]) == 3.0
    # an overwriting save publishes the NEW contents
    mgr.save("last", _state(2), {"epoch": 2})
    mgr.finalize()
    got2, meta2 = mgr.restore("last", _state(0), device="cpu")
    assert meta2 == {"epoch": 2}
    assert float(got2.module.weight[0, 0]) == 2.0 and got2.step == 0


def test_an_update_after_save_cannot_reach_the_checkpoint(tmp_path,
                                                          monkeypatch):
    """The next optimizer step updates parameters and moments in place while
    the background thread may not have started writing: what was saved is
    the state at the time of `save`."""
    gate = threading.Event()
    real_save = torch.save

    def slow_save(*a, **k):
        gate.wait(30)
        return real_save(*a, **k)

    monkeypatch.setattr(torch, "save", slow_save)
    state = _state(1, steps=1)
    want_w = state.module.weight.detach().clone()
    want_m = [s["exp_avg"].clone()
              for s in state.optimizer.adamw.state.values()]
    mgr = CheckpointManager(str(tmp_path), "val_acc")
    mgr.save("last", state, {"epoch": 0})
    # the write is held back; train on, in place
    for _ in range(2):
        state.optimizer.zero_grad()
        state.module(torch.ones(3, 4)).sum().backward()
        state.optimizer.update()
        state.step += 1
    assert not torch.equal(state.module.weight, want_w)
    assert os.path.exists(tmp_path / "last.ckpt.tmp") or not gate.is_set()
    gate.set()
    got, _ = mgr.restore("last", _state(0), device="cpu")
    assert torch.equal(got.module.weight, want_w) and got.step == 1
    for s, m in zip(got.optimizer.adamw.state.values(), want_m):
        assert torch.equal(s["exp_avg"], m)


def test_a_failed_write_is_raised_at_the_next_flush(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise OSError("disk full")

    mgr = CheckpointManager(str(tmp_path), "val_acc")
    monkeypatch.setattr(torch, "save", broken)
    mgr.save("last", _state(1))
    with pytest.raises(OSError, match="disk full"):
        mgr.finalize()
    monkeypatch.undo()
    assert not mgr.exists("last")         # nothing half-published
    mgr.save("last", _state(1))           # and the manager goes on working
    assert mgr.exists("last")


def test_restore_runs_on_the_card_unless_told(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "val_acc")
    mgr.save("last", _state(1))
    if torch.cuda.is_available():
        pytest.skip("this test is about a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore("last", _state(0))


# ---- crash and resume -----------------------------------------------------

TINY_ENC_JSON = {
    "vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 2,
    "num_attention_heads": 4, "intermediate_size": 64,
    "max_position_embeddings": 128, "type_vocab_size": 1,
    "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
}
TINY_DEC_JSON = dict(TINY_ENC_JSON, vocab_size=320, max_position_embeddings=32)


def _train_argv(root, save):
    return [
        "--task", "condition", "--do_train",
        "--data_path", root, "--train_file", "train.csv",
        "--valid_file", "val.csv", "--test_file", "test.csv",
        "--corpus_file", os.path.join(root, "corpus.csv"),
        "--nn_path", root, "--train_nn_file", "train_nn.json",
        "--valid_nn_file", "val_nn.json", "--test_nn_file", "test_nn.json",
        "--text_vocab_file", os.path.join(root, "text_vocab.txt"),
        "--encoder", os.path.join(root, "enc.json"),
        "--decoder", os.path.join(root, "dec.json"),
        "--encoder_tokenizer", "text", "--num_neighbors", "2",
        "--use_gold_neighbor", "--max_length", "64",
        "--max_dec_length", "16", "--batch_size", "8",
        "--epochs", "4", "--lr", "1e-3", "--save_path", save,
        "--compute_dtype", "float32", "--mlm", "--mlm_layer", "mlp",
        "--log_every", "1", "--debug",
    ]


def _run_worker(crash_at, argv):
    worker = os.path.join(REPO, "tests", "_torch_crash_train_worker.py")
    return subprocess.run(
        [sys.executable, worker, str(crash_at)] + argv,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO,
        timeout=600)


def _losses_by_step(path):
    rows = []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if "train_loss" in r:
                rows.append(r)
    return rows


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_sigkill_mid_epoch_resumes_with_loss_continuity(tmp_path):
    """A real SIGKILL mid-epoch, restart, resume from the last published
    checkpoint: no visible half checkpoint, the replayed steps log exactly
    the pre-crash losses (data order keyed by (seed, epoch, index), dropout
    generator by (seed, step), MLM on, dropout 0.1), and the final
    checkpoint is bit-identical to an uninterrupted run's: parameters, both
    moments, the update count and the step."""
    root = make_condition_data(str(tmp_path / "data"))
    for name, js in [("enc.json", TINY_ENC_JSON), ("dec.json", TINY_DEC_JSON)]:
        with open(os.path.join(root, name), "w") as f:
            json.dump(js, f)

    save_a = str(tmp_path / "out_uninterrupted")
    proc = _run_worker(0, _train_argv(root, save_a))
    assert proc.returncode == 0, proc.stdout.decode()[-3000:]

    # killed before step 9 (mid-epoch 2 of 3-step epochs)
    save_b = str(tmp_path / "out_crashed")
    proc = _run_worker(8, _train_argv(root, save_b))
    assert proc.returncode == -signal.SIGKILL, (proc.returncode,
                                                proc.stdout.decode()[-2000:])
    assert os.path.isfile(os.path.join(save_b, "best.ckpt")), os.listdir(save_b)
    for name in ("best", "last"):   # what is visible is complete
        payload = torch.load(os.path.join(save_b, f"{name}.ckpt"),
                             weights_only=True)
        assert set(payload) == {"module", "optimizer", "step"}
    pre_crash = _losses_by_step(os.path.join(save_b, "metrics.jsonl"))
    assert len(pre_crash) == 8, pre_crash

    # restart: same command, no --overwrite -> resume
    proc = _run_worker(0, _train_argv(root, save_b))
    assert proc.returncode == 0, proc.stdout.decode()[-3000:]
    assert not [e for e in os.listdir(save_b) if e.endswith(".tmp")]
    with open(os.path.join(save_b, "metrics.jsonl")) as f:
        resume_recs = [json.loads(l) for l in f if "resumed_at_epoch" in l]
    assert resume_recs, "restart did not resume from a published checkpoint"
    assert resume_recs[-1]["resumed_from"] == "best"
    assert resume_recs[-1]["resumed_at_epoch"] >= 1, resume_recs

    all_rows = _losses_by_step(os.path.join(save_b, "metrics.jsonl"))
    resumed = all_rows[len(pre_crash):]
    pre_by_step = {r["step"]: r for r in pre_crash}
    overlap = [(r, pre_by_step[r["step"]]) for r in resumed
               if r["step"] in pre_by_step]
    assert overlap, (pre_crash, resumed)
    for got, want in overlap:
        for key in ("train_loss", "mlm_loss", "grad_norm"):
            assert got[key] == want[key], (key, got, want)

    tree_a = torch.load(os.path.join(save_a, "last.ckpt"), weights_only=True)
    tree_b = torch.load(os.path.join(save_b, "last.ckpt"), weights_only=True)
    leaves_a, leaves_b = dict(_flat(tree_a)), dict(_flat(tree_b))
    assert leaves_a.keys() == leaves_b.keys() and len(leaves_a) > 100
    for key, la in leaves_a.items():
        lb = leaves_b[key]
        if torch.is_tensor(la):
            assert torch.equal(la, lb), key
        else:
            assert la == lb, key
    assert tree_a["step"] == 12
    metas = []
    for save in (save_a, save_b):
        with open(os.path.join(save, "last.meta.json")) as f:
            metas.append(json.load(f))
    assert metas[0]["epoch"] == metas[1]["epoch"] == 3


# ---- remat ----------------------------------------------------------------


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_remat_gives_the_gradients_of_no_remat(p):
    """`remat=True` recomputes every block in the backward. The dropout
    masks come from an explicit generator, which torch.utils.checkpoint does
    not preserve: the recomputation must replay the generator's state, or
    its masks differ and the gradients are wrong without any error. Same
    seed, same loss, equal gradients (recomputing repeats the same
    arithmetic: tolerance 0)."""
    enc = TransformerConfig(vocab_size=50, hidden_size=128,
                            num_hidden_layers=2, num_attention_heads=2,
                            intermediate_size=256,
                            max_position_embeddings=128,
                            hidden_dropout_prob=p,
                            attention_probs_dropout_prob=p,
                            attention_impl="flash", layernorm_impl="fused")
    dec = enc.replace(vocab_size=30, is_decoder=True,
                      add_cross_attention=True)
    rng = np.random.default_rng(0)
    B, L, LD = 2, 128, 8
    mask = np.ones((B, L), np.int64)
    mask[1, 70:] = 0
    batch = dict(
        input_ids=torch.tensor(rng.integers(1, 50, (B, L))),
        attention_mask=torch.tensor(mask),
        decoder_input_ids=torch.tensor(rng.integers(1, 30, (B, LD))),
        decoder_attention_mask=torch.ones(B, LD, dtype=torch.int64))
    results = []
    for remat in (False, True):
        model = EncoderDecoder(enc, dec, dtype=torch.float32, remat=remat)
        init_weights(model, torch.Generator().manual_seed(0))
        model.train()
        gen = torch.Generator().manual_seed(123)
        out = model(**batch, generator=gen)
        loss = out["logits"].square().mean()
        loss.backward()
        results.append((float(loss), gen.get_state(),
                        {n: q.grad.clone()
                         for n, q in model.named_parameters()}))
        if remat:   # no recomputation outside training
            model.eval()
            with torch.no_grad():
                model(**batch)
    (loss_a, state_a, grads_a), (loss_b, state_b, grads_b) = results
    assert loss_a == loss_b
    # the generator ends where it would have without the recomputation
    assert torch.equal(state_a, state_b)
    assert grads_a.keys() == grads_b.keys()
    for name, g in grads_a.items():
        assert torch.equal(g, grads_b[name]), name


def test_remat_without_generator_replay_would_differ():
    """The guard above has teeth: with the generator left where the forward
    pass ended, the recomputed masks differ and so do the gradients."""
    import torch.utils.checkpoint as ckpt
    from textreact_tpu_torch.models.layers import TransformerBlock
    cfg = TransformerConfig(hidden_size=128, num_attention_heads=2,
                            intermediate_size=256, hidden_dropout_prob=0.3,
                            attention_probs_dropout_prob=0.3)
    block = TransformerBlock(cfg, torch.float32).train()
    x = torch.randn(2, 16, 128)
    grads = []
    for mode in ("plain", "naive_checkpoint"):
        gen = torch.Generator().manual_seed(5)
        block.zero_grad()
        if mode == "plain":
            out = block(x, generator=gen)
        else:
            out = ckpt.checkpoint(lambda t: block(t, generator=gen), x,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
        out.square().sum().backward()
        grads.append(block.ffn.output.weight.grad.clone())
    assert not torch.equal(grads[0], grads[1])
