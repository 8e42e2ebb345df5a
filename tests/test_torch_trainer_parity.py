"""The port's trainer against the JAX trainer, on the CPU: the same fixture
data, the JAX package's initial parameters carried over with `from_flax`,
float32, dropout 0. A test-only run gives identical predicted strings and
scores within 1e-4, and a one-epoch fit logs the same train_loss, MLM loss
and gradient norm within 1e-4 (f32 on both sides: summation order, and from
the second step on the two optimizers' rounding)."""

import json
import os

import jax
import numpy as np
import pytest

import textreact_tpu.config as jax_config
import textreact_tpu_torch.config as port_config
from fixtures import make_condition_data
from textreact_tpu.train.trainer import Trainer as JaxTrainer
from textreact_tpu_torch.models import from_flax
from textreact_tpu_torch.train.trainer import Trainer

TOL = 1e-4
TINY_ENC_JSON = {
    "vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 2,
    "num_attention_heads": 4, "intermediate_size": 64,
    "max_position_embeddings": 128, "type_vocab_size": 1,
    "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
}
TINY_DEC_JSON = dict(TINY_ENC_JSON, vocab_size=320, max_position_embeddings=32)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = make_condition_data(str(tmp_path_factory.mktemp("parity")))
    with open(os.path.join(root, "enc.json"), "w") as f:
        json.dump(TINY_ENC_JSON, f)
    with open(os.path.join(root, "dec.json"), "w") as f:
        json.dump(TINY_DEC_JSON, f)
    return root


def _cfgs(root, save, **kw):
    base = dict(
        task="condition", data_path=root, train_file="train.csv",
        valid_file="val.csv", test_file="test.csv",
        corpus_file=os.path.join(root, "corpus.csv"), nn_path=root,
        train_nn_file="train_nn.json", valid_nn_file="val_nn.json",
        test_nn_file="test_nn.json",
        text_vocab_file=os.path.join(root, "text_vocab.txt"),
        encoder=os.path.join(root, "enc.json"),
        decoder=os.path.join(root, "dec.json"), encoder_tokenizer="text",
        num_neighbors=2, use_gold_neighbor=True, max_length=64,
        max_dec_length=16, batch_size=8, test_batch_size=8, epochs=1,
        lr=1e-3, num_beams=3, compute_dtype="float32", log_every=1,
        length_buckets=(64,), dec_length_buckets=(16,), mlm=True,
        mlm_ratio=0.15, mlm_layer="mlp", mlm_lambda=0.1, debug=True,
        decode_scores_dtype="float32")
    base.update(kw)
    return (jax_config.ExperimentConfig(
                **base, save_path=os.path.join(root, save + "_jax")),
            port_config.ExperimentConfig(
                **base, save_path=os.path.join(root, save + "_port")))


def _trainers(root, save, **kw):
    jcfg, pcfg = _cfgs(root, save, **kw)
    jtrainer = JaxTrainer(jcfg)
    ptrainer = Trainer(pcfg, device="cpu")
    params = jax.device_get(jtrainer._init_params())
    missing = ptrainer.module.load_state_dict(from_flax(params))
    assert not missing.missing_keys and not missing.unexpected_keys
    for t in (jtrainer, ptrainer):
        t.prepare_data()
    return jtrainer, ptrainer


def test_test_only_run_gives_the_same_predictions(workdir, capsys):
    jtrainer, ptrainer = _trainers(workdir, "test_only", do_test=True)
    want = jtrainer.test()
    got = ptrainer.test()
    assert got == want and len(got) == 2
    for li in (0, 1):
        preds = []
        for t in (jtrainer, ptrainer):
            with open(os.path.join(t.cfg.save_path,
                                   f"prediction_test_{li}.json")) as f:
                preds.append(json.load(f))
        assert preds[0].keys() == preds[1].keys() and len(preds[0]) == 8
        for key, a in preds[0].items():
            b = preds[1][key]
            assert a["prediction"] == b["prediction"], key
            np.testing.assert_allclose(b["score"], a["score"], rtol=0,
                                       atol=TOL)
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert len(printed) == 4 and printed[:2] == printed[2:]


def test_first_optimizer_steps_log_the_same_losses(workdir):
    jtrainer, ptrainer = _trainers(workdir, "fit", do_train=True)
    rows = []
    for t in (jtrainer, ptrainer):
        t.fit()
        with open(os.path.join(t.cfg.save_path, "metrics.jsonl")) as f:
            rows.append([json.loads(line) for line in f])
    jrows, prows = ([r for r in rr if "train_loss" in r] for rr in rows)
    assert [r["step"] for r in jrows] == [r["step"] for r in prows] == [1, 2, 3]
    for a, b in zip(jrows, prows):
        for key in ("train_loss", "mlm_loss", "total_loss", "grad_norm"):
            assert abs(a[key] - b[key]) <= TOL, (key, a, b)
    jval, pval = ([r for r in rr if "val_acc" in r] for rr in rows)
    assert len(jval) == len(pval) == 1
    assert jval[0]["val_acc"] == pval[0]["val_acc"]
    assert jval[0]["val_acc/1"] == pval[0]["val_acc/1"]
    assert ptrainer.ckpt.exists("best") and ptrainer.ckpt.exists("last")
