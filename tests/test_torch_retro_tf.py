"""The template-free retrosynthesis recipe (scripts/torch_port/
train_RetroSyn_tf.sh) on the port's trainer against the JAX trainer, on the
CPU: the retro fixture, tiny widths (an encoder over the joint vocabulary of
700 and a decoder over the SMILES vocabulary's table of 600, as the slow
parity_run smoke has them), float32, dropout 0, --shuffle_smiles --mlm,
beam 20 over the recipe's 160 decoder positions, and the JAX package's
initial parameters carried over with `from_flax`.

- A test-only run gives identical predicted strings, scores within 1e-4
  and identical printed retro dicts for both corpora.
- A one-epoch fit logs the same train_loss, MLM loss, total loss and
  gradient norm within 1e-4 (f32 on both sides: summation order, and from
  the second step on the two optimizers' rounding), and the same
  validation metrics.
- The port's cached beam scores equal the teacher-forced decoder's
  log-probabilities of the same sequences within chip_smoke's stated f32
  tolerance (`rescore_tolerance`): the CPU twin of chip_smoke.py's check
  of the 160-slot grouped cache and its ancestry bias, so a fault in the
  ancestor table or the bias shows here first."""

import _torch_threads  # noqa: F401  (before torch runs)
import json
import os

import jax
import numpy as np
import pytest

import textreact_tpu.config as jax_config
import textreact_tpu_torch.config as port_config
from chip_smoke import rescore_tolerance, teacher_forced_scores
from fixtures import make_retro_data
from textreact_tpu.train.trainer import Trainer as JaxTrainer
from textreact_tpu_torch.inference import Generator
from textreact_tpu_torch.models import from_flax
from textreact_tpu_torch.train.trainer import Trainer

TOL = 1e-4
BEAMS, DEC_LEN = 20, 160
RETRO_KS = {1, 2, 3, 5, 10, 20}
TINY_ENC_JSON = {
    "vocab_size": 700, "hidden_size": 32, "num_hidden_layers": 2,
    "num_attention_heads": 4, "intermediate_size": 64,
    "max_position_embeddings": 128, "type_vocab_size": 1,
    "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
}
TINY_DEC_JSON = dict(TINY_ENC_JSON, vocab_size=600,
                     max_position_embeddings=DEC_LEN)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = make_retro_data(str(tmp_path_factory.mktemp("retro_tf")))
    with open(os.path.join(root, "enc.json"), "w") as f:
        json.dump(TINY_ENC_JSON, f)
    with open(os.path.join(root, "dec.json"), "w") as f:
        json.dump(TINY_DEC_JSON, f)
    with open(os.path.join(root, "dec_sharp.json"), "w") as f:
        json.dump(dict(TINY_DEC_JSON, initializer_range=0.2), f)
    return root


def _cfgs(root, save, **kw):
    base = dict(
        task="retro", data_path=root, train_file="train.csv",
        valid_file="valid.csv", test_file="test.csv",
        corpus_file=os.path.join(root, "corpus.csv"), nn_path=root,
        train_nn_file="train_nn.json", valid_nn_file="valid_nn.json",
        test_nn_file="test_nn.json",
        text_vocab_file=os.path.join(root, "text_vocab.txt"),
        encoder=os.path.join(root, "enc.json"),
        decoder=os.path.join(root, "dec.json"), encoder_tokenizer="text",
        num_neighbors=2, use_gold_neighbor=True, random_neighbor_ratio=0.2,
        max_length=64, max_dec_length=DEC_LEN, batch_size=8,
        test_batch_size=8, epochs=1, lr=1e-3, num_beams=BEAMS,
        compute_dtype="float32", dp_size=1, log_every=1,
        length_buckets=(64,), dec_length_buckets=(DEC_LEN,),
        shuffle_smiles=True, mlm=True, mlm_ratio=0.15, mlm_layer="mlp",
        mlm_lambda=0.1, debug=True, decode_scores_dtype="float32")
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
    for acc in got:
        assert set(acc) == RETRO_KS
    for li in (0, 1):
        preds = []
        for t in (jtrainer, ptrainer):
            with open(os.path.join(t.cfg.save_path,
                                   f"prediction_test_{li}.json")) as f:
                preds.append(json.load(f))
        assert preds[0].keys() == preds[1].keys() and len(preds[0]) == 6
        for key, a in preds[0].items():
            b = preds[1][key]
            assert len(a["prediction"]) == BEAMS
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
    assert [r["step"] for r in jrows] == [r["step"] for r in prows] == [1, 2]
    for a, b in zip(jrows, prows):
        for key in ("train_loss", "mlm_loss", "total_loss", "grad_norm"):
            assert abs(a[key] - b[key]) <= TOL, (key, a, b)
    jval, pval = ([r for r in rr if "val_acc" in r] for rr in rows)
    assert len(jval) == len(pval) == 1
    assert jval[0]["val_acc"] == pval[0]["val_acc"]
    assert jval[0]["val_acc/1"] == pval[0]["val_acc/1"]


def test_cached_beam_scores_equal_teacher_forced_rescoring(workdir):
    """Beam 20 over 160 positions through the row-stable 160-slot grouped
    cache (6 examples x 20 beams) under its ancestry bias and the windows
    48, 80, 160, then the same sequences through the teacher-forced
    decoder: every score within rescore_tolerance, and the sequences long
    enough for the beams to fork and reorder many times. The decoder is
    drawn at initializer_range 0.2, ten times the preset's, so that a
    token's log-probability depends on its history: at 0.02 and width 32
    it barely does, and a cache whose rows followed no parent stayed
    within 0.39 of the tolerance; at 0.2 an ancestor table never gathered,
    or a bias admitting each beam's own row, exceeds it 2,490-fold, while
    the true cache stays under 0.02 of it."""
    _, pcfg = _cfgs(workdir, "rescore", do_test=True,
                    decoder=os.path.join(workdir, "dec_sharp.json"))
    ptrainer = Trainer(pcfg, device="cpu")
    ptrainer.prepare_data()
    module = ptrainer.module
    batch = next(iter(ptrainer._loaders(ptrainer.test_dataset, True)[0]))
    gen = Generator(module, num_beams=BEAMS, max_length=DEC_LEN)
    seqs, scores = gen.generate(batch.arrays)
    assert seqs.shape == (8, BEAMS, DEC_LEN) and gen.last_steps > 20
    rescored, n_tokens = teacher_forced_scores(
        module, batch.arrays, seqs, gen.last_steps,
        module.decoder_config.eos_token_id)
    real = batch.arrays["example_mask"].astype(bool)
    assert real.sum() == 6 and n_tokens[real].max() > 20
    diff = np.abs(rescored - scores.astype(np.float64))[real]
    assert (diff <= rescore_tolerance(n_tokens, scores)[real]).all(), \
        diff.max()
