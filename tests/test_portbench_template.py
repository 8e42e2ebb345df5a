"""The benchmark's template-based training cell (`retro_tb.train`: the kind
portbench/kinds/train_template.py, the traffic
portbench/traffic_template.py, the plain reference
portbench/reference/template.py, the FLOPs portbench/flops_template.py)
on the CPU at a tiny size (portbench/tests/tiny_template.py).

- The port's TemplateBasedModel, built by `build_model` and loaded with
  the benchmark's weights, against the reference: atom and bond logits,
  the loss and every gradient, under the bond mask and under the key mask,
  at dropout 0 and 0.1 (the program's masks, drawn in its order); the
  bond mask changes the result; the program's factored bond head equals
  the reference's published concat head.
- The traffic: each example's mask is `RetrosynthesisDataset._bond_mask`'s
  on the example's atoms and bonds, with MLM (the atoms moved with their
  tokens, the mask kept at the unmoved positions) and without; the pool's
  shapes are the same for every seed; the joint vocabulary's layout is the
  port's tokenizer's.
- The FLOPs: an all-ones mask counts as `flops.py` counts a prompt.
- A tiny cell through `portbench.run.main` in a subprocess: `correct`
  true, the traced line's plain-attention count, and `correct` false under
  the mask-dropped and half-batch faults planted in the program.
- The reference and the kind's numpy parts import nothing of the program
  or of JAX.
"""

import _torch_threads  # noqa: F401  (before torch runs)
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import flops, flops_template, traffic_template, weights
from portbench.kinds import train, train_template
from portbench.reference import encdec, template
from portbench.tests import tiny, tiny_template
from textreact_tpu_torch.data import RetrosynthesisDataset
from textreact_tpu_torch.data.mlm import remap_positions
from textreact_tpu_torch.models import build_model
from textreact_tpu_torch.train import make_loss_fn

CONFIG, MIX = tiny_template.CONFIG, tiny_template.TRAIN
SEED = 2**31 + 101


def _config(p: float) -> dict:
    enc = dict(CONFIG["encoder"], hidden_dropout_prob=p,
               attention_probs_dropout_prob=p)
    return dict(CONFIG, encoder=enc)


def _batch(key_mask: bool) -> dict:
    arrays = traffic_template.pool(MIX, CONFIG, SEED)[0]
    batch = train._tensors(arrays, 0, torch.device("cpu"))
    if key_mask:
        batch["attention_mask"] = batch["attention_mask"].diagonal(
            dim1=1, dim2=2).contiguous()
    return batch


def _params(cfg: dict) -> dict:
    return weights.make(train_template.specs(cfg), SEED,
                        cfg["encoder"]["initializer_range"], torch.float32,
                        torch.device("cpu"))


def _program(cfg: dict, batch: dict, seed: int):
    """(atom logits, bond logits, loss, gradients by name) of the port."""
    exp = train_template.experiment(cfg, "tiny_tb", 0)
    ids = cfg["encoder_ids"]
    module, _, _ = build_model(
        exp, train_template.program.Vocab(ids["vocab_size"], ids["pad"]),
        train_template.Tables(cfg["num_atom_templates"],
                              cfg["num_bond_templates"]), device="cpu")
    weights.load_into(module, _params(cfg))
    module.train()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        atom, bond = module(batch["input_ids"], batch["attention_mask"],
                            batch["atom_indices"], batch["bond_pairs"],
                            position_ids=batch["position_ids"],
                            generator=gen)["logits"]
    gen.manual_seed(seed)
    loss, _ = make_loss_fn(module, exp, 0)(batch, gen)
    loss.backward()
    return atom, bond, loss, {n: p.grad for n, p in
                              module.named_parameters()}


def _reference(cfg: dict, batch: dict, seed: int):
    params = _params(cfg)
    for p in params.values():
        p.requires_grad_(True)
    model = template.TemplateModel(params, cfg["encoder"],
                                   encdec.Products("f32"))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        enc = model.encode(batch["input_ids"], batch["attention_mask"],
                           batch["position_ids"],
                           encdec.Draws(gen, kernels=False))
        atom, bond = model.heads(enc, batch["atom_indices"],
                                 batch["bond_pairs"])
    gen.manual_seed(seed)
    loss = template.train_loss(model, batch, cfg["mlm_lambda"],
                               encdec.Draws(gen, kernels=False))
    loss.backward()
    return atom, bond, loss, {n: p.grad for n, p in params.items()}


def _close(got, want, what, rtol=2e-5, floor=0.0):
    """|got - want| within rtol of want's largest entry, or of `floor` (a
    key's bias has a gradient of round-off alone under softmax)."""
    scale = float(want.detach().abs().max())
    err = float((got.detach().float() - want.detach().float()).abs().max())
    assert err <= rtol * max(scale, floor, 1e-30), (what, err, scale)


@pytest.mark.parametrize("p", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("key_mask", [False, True],
                         ids=["bond_mask", "key_mask"])
def test_program_equals_the_reference(p, key_mask):
    cfg, batch = _config(p), _batch(key_mask)
    got, want = _program(cfg, batch, 7), _reference(cfg, batch, 7)
    for i, what in enumerate(("atom logits", "bond logits", "loss")):
        _close(got[i], want[i], what)
    assert set(got[3]) == set(want[3])
    floor = float(np.median([float(g.abs().max())
                             for g in want[3].values()]))
    for name, g in want[3].items():
        _close(got[3][name], g, name, rtol=1e-4, floor=floor)


def test_the_bond_mask_changes_the_result():
    cfg = _config(0.0)
    bond, key = _reference(cfg, _batch(False), 7), _reference(
        cfg, _batch(True), 7)
    assert float((bond[0] - key[0]).abs().max()) > 1e-3 * float(
        key[0].abs().max())
    assert abs(float(bond[2].detach()) - float(key[2].detach())) > 1e-6
    prog = _program(cfg, _batch(False), 7)
    assert float((prog[0] - key[0]).abs().max()) > 1e-3 * float(
        key[0].abs().max())


def test_factored_bond_head_equals_the_concat_head():
    from textreact_tpu_torch.models import TemplateHead
    torch.manual_seed(3)
    d, n_b = 32, 7
    head = TemplateHead(d, 5, n_b)
    states = torch.randn(2, 9, d)
    pairs = torch.randint(0, 9, (2, 6, 2))
    _, got = head(states, pairs)
    params = {"head.atom_head.weight": head.atom_head.weight,
              "head.atom_head.bias": head.atom_head.bias,
              "head.bond_head_left.weight": head.bond_head_left.weight,
              "head.bond_head_left.bias": head.bond_head_left.bias,
              "head.bond_head_right.weight": head.bond_head_right.weight}
    model = template.TemplateModel(params, {}, encdec.Products("f32"))
    _, want = model.heads(states, torch.arange(9).expand(2, 9), pairs)
    _close(got.detach(), want.detach(), "bond logits", rtol=1e-6)


@pytest.mark.parametrize("mlm", [True, False], ids=["mlm", "no_mlm"])
def test_masks_follow_the_datasets_rule(mlm):
    mix = dict(MIX) if mlm else {k: v for k, v in MIX.items() if k != "mlm"}
    rng = np.random.default_rng(SEED)
    atoms, rings = traffic_template.sizes(mix, mix["micro_batch_size"])
    rows = [traffic_template.example(rng, int(a), int(r), mix, CONFIG)
            for a, r in zip(atoms, rings)]
    arrays = traffic_template.collate(rows, CONFIG)
    L = mix["prompt"]["length"]
    for i, ex in enumerate(rows):
        enc_input = {"attention_mask": [1] * L,
                     "atom_indices": ex["atoms"].tolist(),
                     "bonds": ex["bonds"].tolist()}
        want = RetrosynthesisDataset._bond_mask(enc_input)
        np.testing.assert_array_equal(arrays["attention_mask"][i], want)
        n = len(ex["atoms"])
        assert (want[np.ix_(ex["atoms"], ex["atoms"])].sum()
                == n + len(ex["bonds"]))
        moved = remap_positions(ex["pos"].tolist(), ex["atoms"].tolist())
        np.testing.assert_array_equal(arrays["atom_indices"][i, :n], moved)
        kept = ex["ids"] != CONFIG["encoder_ids"]["mask"]
        np.testing.assert_array_equal(ex["ids"][kept],
                                      ex["row"][ex["pos"]][kept])
        assert (np.array_equal(ex["pos"], np.arange(L))) != mlm
        # the atoms' first token is the product's first, one past [CLS]
        assert ex["atoms"][0] == 1 and ex["row"][0] == CONFIG[
            "encoder_ids"]["cls"]


@pytest.mark.parametrize("seed", [0, 2**31 + 17, 3 * 2**31 + 5])
def test_pool_shapes_are_the_same_for_every_seed(seed):
    from portbench import traffic
    cfg = json.loads((tiny.REPO / "portbench" / "configs"
                      / "retro_tb.json").read_text())
    mix = dict(traffic.load("train_templates"), pool_steps=2,
               micro_batch_size=8)
    for c, m in ((cfg, mix), (CONFIG, MIX)):
        shapes = {tuple(sorted((k, v.shape) for k, v in step.items()))
                  for step in traffic_template.pool(m, c, seed)}
        want = {tuple(sorted((k, v.shape) for k, v in step.items()))
                for step in traffic_template.pool(m, c, 1)}
        assert shapes == want and len(shapes) == 1


def test_the_joint_vocabulary_is_the_tokenizers(tmp_path):
    """SciBERT's vocabulary layout ([PAD] 0, [UNK] 101, [CLS] 102, [SEP]
    103, [MASK] 104, 31,090 ids) joined with the port's SMILES vocabulary
    (591 tokens), as get_tokenizers builds it for 'smiles_text'."""
    from textreact_tpu_torch.tokenizers import (JointSmilesTextTokenizer,
                                                SmilesTokenizer)
    from textreact_tpu_torch.tokenizers.text import make_text_tokenizer
    cfg = json.loads((tiny.REPO / "portbench" / "configs"
                      / "retro_tb.json").read_text())
    words = [f"[unused{i}]" for i in range(31090)]
    for i, tok in ((0, "[PAD]"), (101, "[UNK]"), (102, "[CLS]"),
                   (103, "[SEP]"), (104, "[MASK]")):
        words[i] = tok
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(words) + "\n")
    tok = JointSmilesTextTokenizer(make_text_tokenizer(str(vocab)),
                                   SmilesTokenizer(None))
    ids = cfg["encoder_ids"]
    assert len(tok) == ids["vocab_size"] == cfg["encoder"]["vocab_size"] + 591
    enc = tok("CCO", text_pair=["[unused200]"])
    assert enc["input_ids"][0] == ids["cls"]
    assert ids["sep"] in enc["input_ids"]
    assert enc["input_ids"][-1] == ids["text_sep"]
    assert tok.mask_token_id == ids["mask"]
    assert ids["first_atom_token"] == tok.smiles_offset + 15


def test_all_ones_mask_counts_as_flops_py():
    arrays = traffic_template.pool(MIX, CONFIG, SEED)[0]
    one = {k: v[0] for k, v in arrays.items()}
    ones = dict(one, attention_mask=np.ones_like(one["attention_mask"]))
    enc = CONFIG["encoder"]
    B, L = one["input_ids"].shape
    heads = (int((one["atom_template_labels"] != -100).sum()) * 2 * 128 * 11
             + int((one["bond_template_labels"] != -100).sum()) * 4 * 128 * 7)
    mlm = flops.mlm_flops(int((one["mlm_labels"] != -100).sum()),
                          dict(enc, vocab_size=340))
    want = flops.encoder_flops(np.full(B, L), enc) + mlm + heads
    assert flops_template.forward_flops(ones, CONFIG) == pytest.approx(want)
    assert flops_template.forward_flops(one, CONFIG) < want


# --- the tiny cell through the harness ---------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_template.checkout(tmp_path_factory.mktemp("portbench_tb"))


def _run(root, trace=0, prelude=""):
    rc, out, err = tiny.run_cell(root, tiny_template.CELL, trace=trace,
                                 prelude=prelude)
    assert rc == 0, err[-3000:]
    return tiny.last_json(out)


def test_the_cell_is_correct(root):
    res = _run(root)
    assert res["correct"] is True, res["compared"]
    assert set(res["metrics"]) == {"train_examples_per_s", "setup_s"}
    assert set(res["compared"]) == set(tiny_template.LIMITS)


def test_the_traced_line_counts_the_plain_calls(root):
    res = _run(root, trace=1)
    assert res["correct"] is True
    layers = CONFIG["encoder"]["num_hidden_layers"]
    assert res["metrics"]["train.plain_attention_calls_per_step.tb"][
        "value"] == layers * MIX["micro_batches"]


@pytest.mark.parametrize("fault", ["MASK_DROPPED", "HALF_BATCH"])
def test_a_fault_turns_correct_false(root, fault):
    res = _run(root, prelude=getattr(tiny_template, fault))
    assert res["correct"] is False, res["compared"]


def test_reference_loads_no_program(root):
    code = f'''
import json, sys
sys.path.insert(0, {str(root)!r})
from portbench.reference import template
from portbench import flops_template, traffic_template
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
'''
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "optax", "orbax",
                        "textreact_tpu", "textreact_tpu_torch"}
