"""The port's runtime against the JAX package's, on the CPU: datasets,
loader, metrics and the command line end to end at the tiny configuration
of tests/test_end_to_end.py. Every entry point is given device="cpu" /
--device cpu; without it they raise here, where there is no card."""

import copy
import json
import os

import numpy as np
import pandas as pd
import pytest

import textreact_tpu.config as jax_config
import textreact_tpu.data as jax_data
import textreact_tpu.evaluation as jax_eval
import textreact_tpu.tokenizers as jax_tok
import textreact_tpu_torch.config as port_config
import textreact_tpu_torch.data as port_data
import textreact_tpu_torch.evaluation as port_eval
import textreact_tpu_torch.tokenizers as port_tok
from fixtures import make_condition_data, make_retro_data
from textreact_tpu_torch.cli.main import main as port_main
from textreact_tpu_torch.cli.main import parse_config
from textreact_tpu_torch.train.trainer import Trainer
from textreact_tpu_torch.utils.table import Table

TINY_ENC_JSON = {
    "vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 2,
    "num_attention_heads": 4, "intermediate_size": 64,
    "max_position_embeddings": 128, "type_vocab_size": 1,
    "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
}
TINY_DEC_JSON = dict(TINY_ENC_JSON, vocab_size=320, max_position_embeddings=32)


@pytest.fixture(scope="module")
def cond_root(tmp_path_factory):
    return make_condition_data(str(tmp_path_factory.mktemp("rt_cond")))


@pytest.fixture(scope="module")
def retro_root(tmp_path_factory):
    return make_retro_data(str(tmp_path_factory.mktemp("rt_retro")))


def _both(root, task, **kw):
    """(JAX config, port config) over one fixture directory."""
    base = dict(task=task, data_path=root, num_neighbors=2, max_length=64,
                max_dec_length=16, encoder_tokenizer="text",
                text_vocab_file=os.path.join(root, "text_vocab.txt"),
                corpus_file=os.path.join(root, "corpus.csv"))
    base.update(kw)
    return (jax_config.ExperimentConfig(**base),
            port_config.ExperimentConfig(**base))


def _datasets(root, task, split, file, nn_file, **kw):
    jcfg, pcfg = _both(root, task, **kw)
    out = []
    for cfg, data, tok in ((jcfg, jax_data, jax_tok),
                           (pcfg, port_data, port_tok)):
        enc, dec = tok.get_tokenizers(cfg)
        ds = data.DATASET_CLS[task](cfg, os.path.join(root, file), enc, dec,
                                    split=split)
        if cfg.train_label_corpus:
            corpus = data.generate_train_label_corpus(
                os.path.join(root, "train.csv"))
        else:
            corpus = data.read_corpus(cfg.corpus_file)
        ds.load_corpus(corpus, os.path.join(root, nn_file))
        out.append(ds)
    return out


def _same_examples(a, b, epochs=(0, 1), seed=5):
    assert len(a) == len(b) and a.indices == b.indices
    for epoch in epochs:
        for i in range(len(a)):
            ea = a.example(i, rng=jax_data.example_rng(seed, epoch, i))
            eb = b.example(i, rng=port_data.example_rng(seed, epoch, i))
            assert ea == eb, (epoch, i)
    return ea


CONDITION_MODES = {
    "plain": dict(),
    "gold_neighbor": dict(use_gold_neighbor=True),
    "mlm": dict(mlm=True, mlm_ratio=0.3, use_gold_neighbor=True),
    "shuffle_smiles": dict(shuffle_smiles=True),
    "no_smiles": dict(no_smiles=True),
    "train_label_corpus": dict(train_label_corpus=True),
    "no_neighbors": dict(num_neighbors=-1),
    "num_train_example": dict(num_train_example=5),
}


@pytest.mark.parametrize("mode", sorted(CONDITION_MODES))
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_condition_dataset_gives_the_same_examples(cond_root, split, mode):
    a, b = _datasets(cond_root, "condition", split, f"{split}.csv",
                     f"{split}_nn.json", **CONDITION_MODES[mode])
    last = _same_examples(a, b)
    assert ("decoder_input_ids" in last) == (split != "test")
    if mode == "num_train_example":
        assert len(b) == (5 if split == "train" else 8)
    twin_a, twin_b = a.with_skip_gold(), b.with_skip_gold()
    assert twin_b.skip_gold_neighbor and not b.skip_gold_neighbor
    _same_examples(twin_a, twin_b, epochs=(0,))


@pytest.mark.parametrize("mode", ["plain", "shuffle_smiles", "no_smiles",
                                  "each_neighbor"])
@pytest.mark.parametrize("split,file", [("train", "train"), ("val", "valid"),
                                        ("test", "test")])
def test_retro_dataset_gives_the_same_examples(retro_root, split, file, mode):
    kw = {"plain": {}, "shuffle_smiles": dict(shuffle_smiles=True),
          "no_smiles": dict(no_smiles=True),
          "each_neighbor": dict(test_each_neighbor=True, test_num_neighbors=3,
                                num_neighbors=1)}[mode]
    a, b = _datasets(retro_root, "retro", split, f"{file}.csv",
                     f"{file}_nn.json", max_length=96, max_dec_length=32,
                     **kw)
    _same_examples(a, b)
    if mode == "each_neighbor" and split == "test":
        assert len(b) == 3 * len(b.data_df)
        assert b.example(0)["id"] == b.example(2)["id"] != b.example(3)["id"]


def test_template_based_dataset_waits_for_its_slice(tmp_path):
    """The template-based dataset and the template decode, which raised
    until their slice, now run: examples with template labels, atom
    positions and the bond mask equal to the JAX package's, and the retro
    metric through the ester decode equal to its, with the gold edit
    ranked first."""
    from test_torch_template import (PRODUCTS, _write_template_data,
                                     write_ester_data)
    root = _write_template_data(str(tmp_path / "tpl"), PRODUCTS)
    kw = dict(template_based=True, template_path=root, num_neighbors=-1,
              encoder_tokenizer="smiles", corpus_file=None,
              unattend_nonbonds=True, shuffle_smiles=True)
    jcfg, pcfg = _both(root, "retro", **kw)
    datasets = []
    for cfg, data, tok in ((jcfg, jax_data, jax_tok),
                           (pcfg, port_data, port_tok)):
        enc, dec = tok.get_tokenizers(cfg)
        datasets.append(data.RetrosynthesisDataset(
            cfg, os.path.join(root, "train.csv"), enc, dec))
    a, b = datasets
    for i in range(len(a)):
        ea = a.example(i, rng=jax_data.example_rng(5, 0, i))
        eb = b.example(i, rng=port_data.example_rng(5, 0, i))
        mask = eb.pop("attention_mask")    # (L, L) array, JAX: lists
        assert mask.tolist() == ea.pop("attention_mask") and eb == ea, i
    assert mask.shape == (len(eb["input_ids"]),) * 2
    assert eb["decoder_raw_template_labels"]

    ester = write_ester_data(str(tmp_path / "ester"))
    table = port_data.load_preprocessed_labels(ester, "test")[0]
    prediction = {i: {"prediction": [tuple(labels[0])], "score": [0.9]}
                  for i, labels in enumerate(table)}
    got = port_eval.evaluate_retrosynthesis(
        prediction, Table({k: list(v) for k, v in pd.read_csv(
            os.path.join(ester, "test.csv")).items()}), 20,
        template_based=True, template_path=ester)
    want = jax_eval.evaluate_retrosynthesis(
        prediction, pd.read_csv(os.path.join(ester, "test.csv")), 20,
        template_based=True, template_path=ester)
    assert got == want and got[1] == 1.0


@pytest.mark.parametrize("kw", [
    dict(shuffle=True), dict(shuffle=False, augment=False),
    dict(shuffle=True, drop_last=True), dict(shuffle=True, prefetch=0),
    dict(shuffle=True, num_workers=2), dict(shuffle=True, shard=(1, 3))],
    ids=["shuffle", "eval", "drop_last", "no_prefetch", "workers", "shard"])
def test_loader_gives_the_same_order_and_batches(cond_root, kw):
    kw = dict(kw)
    shard = kw.pop("shard", None)
    a, b = _datasets(cond_root, "condition", "train", "train.csv",
                     "train_nn.json", mlm=True, use_gold_neighbor=True,
                     length_buckets=(32, 48, 64))
    loaders = []
    for ds, data in ((a, jax_data), (b, port_data)):
        collator = data.Collator(ds.cfg, ds.enc_tokenizer.pad_token_id,
                                 ds.dec_tokenizer.pad_token_id)
        loader = data.DataLoader(ds, collator, batch_size=5, seed=3, **kw)
        if shard:
            loader.shard_across_processes(*shard)
        loaders.append(loader)
    assert len(loaders[0]) == len(loaders[1])
    for epoch in (0, 2):
        batches = []
        for loader in loaders:
            loader.set_epoch(epoch)
            batches.append(list(loader))
        assert len(batches[0]) == len(batches[1]) > 0
        for x, y in zip(*batches):
            assert x.arrays.keys() == y.arrays.keys()
            for k in x.arrays:
                np.testing.assert_array_equal(x.arrays[k], y.arrays[k], k)
            assert x.host == y.host


def test_loader_refuses_to_fork_once_cuda_is_up(cond_root, monkeypatch):
    import torch
    _, b = _datasets(cond_root, "condition", "train", "train.csv",
                     "train_nn.json")
    collator = port_data.Collator(b.cfg, 0, 0)
    loader = port_data.DataLoader(b, collator, batch_size=5, num_workers=2)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="CUDA runtime"):
        list(loader)


# ---- metrics: the cases of tests/test_eval_parity.py, on both packages ----

_COND = ["catalyst1", "solvent1", "solvent2", "reagent1", "reagent2"]
CONDITION_CASES = {
    "ranks": (
        {"catalyst1": ["", "Pd", ""], "solvent1": ["CCO", "C1CCOC1", ""],
         "solvent2": ["", "", ""], "reagent1": ["O", "", "BrBr"],
         "reagent2": ["", "", ""]},
        {0: {"prediction": [["", "CCO", "", "O", ""], ["x"] * 5]},
         1: {"prediction": [["a"] * 5, ["b"] * 5, ["c"] * 5,
                            ["Pd", "C1CCOC1", "", "", ""]]},
         2: {"prediction": [["z"] * 5] * 15}},
        {1: 1 / 3, 3: 1 / 3, 5: 2 / 3, 10: 2 / 3, 15: 2 / 3}),
    "exact_5_tuple": (
        {"catalyst1": [""], "solvent1": ["CCO"], "solvent2": [""],
         "reagent1": [""], "reagent2": [""]},
        {0: {"prediction": [["", "CCO", "", ""]]}},
        {1: 0.0, 3: 0.0, 5: 0.0, 10: 0.0, 15: 0.0}),
    "nan_slot": (
        {"catalyst1": [np.nan], "solvent1": ["CCO"], "solvent2": [""],
         "reagent1": [""], "reagent2": [""]},
        {0: {"prediction": [["", "CCO", "", "", ""],
                            ["nan", "CCO", "", "", ""]]}},
        {1: 0.0, 3: 0.0, 5: 0.0, 10: 0.0, 15: 0.0}),
    "missing_prediction": (
        {"catalyst1": ["", ""], "solvent1": ["CCO", "CCN"],
         "solvent2": ["", ""], "reagent1": ["", ""], "reagent2": ["", ""]},
        {1: {"prediction": [["", "CCN", "", "", ""]]}},
        {1: 0.5, 3: 0.5, 5: 0.5, 10: 0.5, 15: 0.5}),
}


@pytest.mark.parametrize("case", sorted(CONDITION_CASES))
def test_condition_metric_matches(case):
    columns, prediction, want = CONDITION_CASES[case]
    got = port_eval.evaluate_reaction_condition(prediction, Table(columns))
    assert got == jax_eval.evaluate_reaction_condition(
        prediction, pd.DataFrame(columns))
    assert got == pytest.approx(want)


RETRO_CASES = {
    "equivalent_forms": (["CCO.CC(=O)O", "CCN", "c1ccccc1"],
                         [["CCC", "OCC.OC(C)=O"], ["CCN"], ["C1CCCCC1"]]),
    "duplicate_beams": (["CCO"], [["CCC", "OCC", "CCO", "CCO"]]),
    "kekule": (["c1ccccc1O"], [["OC1=CC=CC=C1"]]),
    "unparseable_gold": (["not_a_smiles"], [["not_a_smiles"]]),
}


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("case", sorted(RETRO_CASES))
def test_retro_metric_matches(case, workers):
    golds, beams = RETRO_CASES[case]
    prediction = {i: {"prediction": b, "score": [0.0] * len(b)}
                  for i, b in enumerate(beams)}
    got = port_eval.evaluate_retrosynthesis(
        prediction, Table({"reactant_smiles": golds}), 20,
        num_workers=workers)
    assert set(got) == {1, 2, 3, 5, 10, 20}
    assert got == jax_eval.evaluate_retrosynthesis(
        prediction, pd.DataFrame({"reactant_smiles": golds}), 20)


def test_retro_rank_and_each_neighbor_aggregation_match():
    from textreact_tpu.chem import canonical_smiles
    gold = canonical_smiles("C(C)O")
    for preds in (["CCC"], ["CC", "C(C)O"], ["CCO"]):
        assert port_eval.compare_pred_and_gold(preds, gold) \
            == jax_eval.compare_pred_and_gold(preds, gold)
    assert port_eval.compare_pred_and_gold(["CCC"], gold) \
        == port_eval.retro.NO_MATCH
    expanded = {i: {"prediction": [[str(i)] * 5], "score": [-float(i)]}
                for i in range(6)}
    assert port_data.gather_prediction_each_neighbor(
        copy.deepcopy(expanded), 3) == jax_eval.gather_prediction_each_neighbor(
            copy.deepcopy(expanded), 3)


# ---- the command line, end to end at the tiny configuration ---------------


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = make_condition_data(str(tmp_path_factory.mktemp("rt_e2e")))
    with open(os.path.join(root, "enc.json"), "w") as f:
        json.dump(TINY_ENC_JSON, f)
    with open(os.path.join(root, "dec.json"), "w") as f:
        json.dump(TINY_DEC_JSON, f)
    return root


def _argv(root, save, *extra, epochs=2):
    return [
        "--task", "condition",
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
        "--test_batch_size", "8", "--epochs", str(epochs), "--lr", "1e-3",
        "--num_beams", "3", "--save_path", os.path.join(root, save),
        "--compute_dtype", "float32", "--log_every", "1", "--debug",
        "--mlm", "--mlm_layer", "mlp", "--mlm_lambda", "0.1", *extra]


def _records(root, save):
    with open(os.path.join(root, save, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_trains_tests_and_writes_its_files(workdir, capsys):
    results = port_main(_argv(workdir, "out", "--do_train", "--do_test",
                              "--device", "cpu"))
    records = _records(workdir, "out")
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    assert len(losses) == 6 and losses[-1] < losses[0], losses
    mlm = [r["mlm_loss"] for r in records if "mlm_loss" in r]
    assert np.mean(mlm[-2:]) < np.mean(mlm[:2]), mlm
    val = [r for r in records if "val_acc" in r]
    assert len(val) == 2 and "val_acc/1" in val[-1]
    out = os.path.join(workdir, "out")
    names = set(os.listdir(out))
    assert {"best.ckpt", "last.ckpt", "best.meta.json", "last.meta.json",
            "metrics.jsonl", "prediction_test_0.json",
            "prediction_test_1.json"} <= names
    assert not [n for n in names if n.endswith(".tmp")]
    assert len(results) == 2
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed == [{str(k): v for k, v in acc.items()} for acc in results]
    for acc in results:
        assert set(acc) == {1, 3, 5, 10, 15}
        assert all(0.0 <= v <= 1.0 for v in acc.values())
    with open(os.path.join(out, "prediction_test_0.json")) as f:
        preds = json.load(f)
    assert len(preds) == 8
    first = next(iter(preds.values()))
    assert len(first["prediction"]) == 3 and len(first["score"]) == 3
    assert all(isinstance(p, list) for p in first["prediction"])


def test_cli_resumes_from_the_checkpoint(workdir):
    """The same command with one more epoch goes on from best.ckpt (saved
    at epoch 0: the tiny model's val_acc never improves on it)."""
    before = len(_records(workdir, "out"))
    port_main(_argv(workdir, "out", "--do_train", "--device", "cpu",
                    epochs=3))
    new = _records(workdir, "out")[before:]
    resumed = [r for r in new if "resumed_at_epoch" in r]
    assert len(resumed) == 1 and resumed[0]["resumed_from"] == "best"
    start = int(resumed[0]["resumed_at_epoch"])
    assert start >= 1
    steps = [r["step"] for r in new if "train_loss" in r]
    assert steps == list(range(3 * start + 1, 10))
    with open(os.path.join(workdir, "out", "last.meta.json")) as f:
        assert json.load(f)["epoch"] == 2


def test_cli_validate_only_loads_best(workdir):
    cfg = parse_config(_argv(workdir, "out", "--do_valid"))
    trainer = Trainer(cfg, device="cpu")
    trainer.prepare_data()
    before = [p.detach().clone() for p in trainer.module.parameters()]
    scores = trainer.validate()
    assert set(scores) == {"val_acc", "val_acc/1"}
    assert all(0.0 <= v <= 1.0 for v in scores.values())
    assert any(not np.array_equal(a.numpy(), b.detach().numpy())
               for a, b in zip(before, trainer.module.parameters()))


@pytest.mark.parametrize("buckets", ["one_bucket", "two_buckets"])
def test_cli_gradient_accumulation(workdir, buckets):
    """24 examples in loader batches of 8 (one shape: one full window and a
    flush padded with a weight-0 micro-batch) or of 4 over several length
    buckets (each shape group accumulates on its own and flushes at the
    epoch's end)."""
    cfg = parse_config(_argv(workdir, f"out_{buckets}", "--do_train",
                             "--gradient_accumulation_steps", "2",
                             "--overwrite", epochs=1))
    if buckets == "one_bucket":
        cfg.length_buckets, cfg.dec_length_buckets = (64,), (16,)
    else:
        cfg.batch_size = 4
        cfg.length_buckets, cfg.dec_length_buckets = (52, 57, 60, 64), (8, 16)
    trainer = Trainer(cfg, device="cpu")
    trainer.prepare_data()
    trainer.fit()
    losses = [r["train_loss"] for r in _records(workdir, f"out_{buckets}")
              if "train_loss" in r]
    assert losses and all(np.isfinite(v) for v in losses)
    groups = trainer._accum_group_count
    if buckets == "one_bucket":
        assert (trainer._state.step, groups) == (2, 1)
    else:
        # 6 loader batches, 2 a step: 3 steps if every group fills its
        # windows, one more for each group left with a single batch
        assert groups >= 2 and 3 <= trainer._state.step <= 3 + groups
    assert trainer._state.optimizer.count == trainer._state.step
    assert trainer.ckpt.exists("last")


def test_entry_points_default_to_the_card_and_raise_without_one(workdir):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this test is about a machine without a card")
    argv = _argv(workdir, "out_nocard", "--do_train")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(parse_config(argv))
    from textreact_tpu_torch.train import run
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(parse_config(argv))
    from textreact_tpu_torch.entry import dryrun_multichip
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(4)


@pytest.mark.parametrize("flags,match", [
    (["--dp_size", "2"], "torchrun"), (["--tp_size", "2"], "torchrun"),
    (["--zero1"], None)])
def test_mesh_options_raise_until_their_slice(workdir, flags, match):
    """The mesh options parse since the multi-device slice; a mesh of more
    than one rank needs as many processes, so a process started alone
    refuses it (tests/test_torch_multihost.py runs them under a launcher),
    and ZeRO-1 on one process shards nothing."""
    cfg = parse_config(_argv(workdir, "out_mesh", *flags))
    if match is None:
        assert cfg.zero1
        assert Trainer(cfg, device="cpu").mesh is None
    else:
        with pytest.raises(ValueError, match=match):
            Trainer(cfg, device="cpu")
    for ok in (["--dp_size", "1"], ["--dp_size", "-1"]):
        assert parse_config(_argv(workdir, "out_mesh", *ok)).tp_size == 1


@pytest.mark.parametrize("flags,match", [
    (["--decoder_pretrained"], "local HF checkpoint directory"),
    (["--encoder_pretrained", "--encoder", "DIR"], "config.json")])
def test_unported_options_raise_naming_their_item(workdir, flags, match):
    """The pretrained options are ported (tests/test_torch_import_hf.py):
    --decoder_pretrained refuses a --decoder that is not a directory, and
    an --encoder directory without an HF checkpoint fails on its
    config.json, as the JAX package does."""
    flags = [workdir if f == "DIR" else f for f in flags]
    cfg = parse_config(_argv(workdir, "out_unported", *flags))
    error = ValueError if "--decoder_pretrained" in flags else \
        FileNotFoundError
    with pytest.raises(error, match=match):
        Trainer(cfg, device="cpu")


def test_profile_flag_writes_a_trace(workdir):
    port_main(_argv(workdir, "out_profile", "--do_train", "--profile",
                    "--overwrite", "--device", "cpu", epochs=1))
    files = os.listdir(os.path.join(workdir, "out_profile", "profile"))
    assert "trace.json" in files and "kernels.txt" in files
