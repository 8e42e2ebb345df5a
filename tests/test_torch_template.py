"""The port's template-based retrosynthesis slice against the JAX package's,
on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and the
port's, with the JAX weights carried over by `from_flax`:
- (a) TemplateBasedModel's atom and bond logits in float32, with the 2-D
  bond mask (plain attention on both sides) and with a key mask only (the
  JAX side's fused attention and residual LN in Pallas interpret mode, the
  port's plain versions of its kernels);
- (b) the loss and every gradient of the train step at dropout 0, and the
  parameters after 3 accumulated steps;
- (c) the eval step's per-example loss and top-k edits; `device_topk_edits`
  against the JAX twin on the same probabilities with planted ties, exactly;
- (d) RetrosynthesisDataset + Collator arrays against the JAX dataset's;
- (e) a trainer twin on the ester fixture of tests/test_template_e2e.py;
- (f) bfloat16 compute on both sides: logits and loss, and a case that
  tells the heads' f32 cast point (encdec.py:131-138) from rounding noise.
Hidden size 128 and L = 128, so the JAX side's kernels run in Pallas.
"""

import ast
import csv
import dataclasses
import functools
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import textreact_tpu.config as jax_config
import textreact_tpu.data as jax_data
import textreact_tpu.tokenizers as jax_tok
import textreact_tpu.train.optim as jax_optim
import textreact_tpu.train.step as jax_step
from textreact_tpu.evaluation.edit_rank import \
    device_topk_edits as jax_device_topk_edits
from textreact_tpu.models import TransformerConfig as JaxConfig
from textreact_tpu.models.encdec import TemplateBasedModel as JaxTemplateModel
from textreact_tpu.models.encdec import TemplateHead as JaxTemplateHead
from textreact_tpu_torch import data as port_data
from textreact_tpu_torch import tokenizers as port_tok
from textreact_tpu_torch.chem import parse_smiles
from textreact_tpu_torch.config import ExperimentConfig
from textreact_tpu_torch.evaluation import (device_topk_edits,
                                            edits_from_topk, rank_edits)
from textreact_tpu_torch.models import (TemplateBasedModel, TemplateHead,
                                        TransformerConfig, from_flax,
                                        grads_from_flax)
from textreact_tpu_torch.train import (TrainState, losses,
                                       make_accum_train_step, make_eval_step,
                                       make_loss_fn, make_optimizer)

# f32 on both sides: values of order 1-10 that differ by summation order
RTOL, ATOL = 1e-5, 2e-5
L, ENC_V, N_A, N_B = 128, 64, 37, 11
EXPERIMENT = dict(task="retro", template_based=True, template_path="x",
                  lr=1e-3, weight_decay=0.01, max_grad_norm=1.0,
                  scheduler="cosine", warmup_ratio=0.25, max_length=L,
                  compute_dtype="float32")
NUM_STEPS = 4   # warmup = 1 update, so update 0 runs at rate 0


def _enc_config():
    return JaxConfig(vocab_size=ENC_V, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=256,
                     max_position_embeddings=L, type_vocab_size=2,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0,
                     attention_impl="flash", layernorm_impl="fused")


def _examples(n, seed, bond_mask):
    """Examples as the template dataset builds them: atom tokens at string
    positions after [CLS], a ring of atoms with one branch as the bond list
    (both directions), an atom label or two and a bond label, and the 2-D
    bond mask under `bond_mask`."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(48, L + 1))
        n_atoms = int(rng.integers(6, 24))
        pos = sorted(int(p) for p in rng.choice(np.arange(1, 46), n_atoms,
                                                replace=False))
        edges = [(a, (a + 1) % (n_atoms - 1)) for a in range(n_atoms - 1)]
        edges.append((0, n_atoms - 1))
        bonds = sorted({e for a, b in edges for e in ((a, b), (b, a))})
        atom_locs = [int(a) for a in rng.choice(n_atoms, 2, replace=False)]
        atom_ids = [int(t) for t in rng.integers(1, N_A + 1, 2)]
        bond_loc = bonds[int(rng.integers(len(bonds)))]
        bond_id = int(rng.integers(1, N_B + 1))
        ex = {"id": str(i), "index": i,
              "input_ids": [2] + [int(t) for t in rng.integers(5, ENC_V,
                                                               length - 1)],
              "attention_mask": [1] * length, "atom_indices": pos,
              "bonds": bonds,
              "decoder_atom_template_locs": atom_locs,
              "decoder_atom_template_ids": atom_ids,
              "decoder_bond_template_locs": [bond_loc],
              "decoder_bond_template_ids": [bond_id],
              "decoder_raw_template_labels":
                  [("a", a, t) for a, t in zip(atom_locs, atom_ids)]
                  + [("b", bond_loc, bond_id)]}
        if bond_mask:
            ex["attention_mask"] = port_data.RetrosynthesisDataset._bond_mask(
                ex)
        out.append(ex)
    return out


def as_lists(examples):
    """Examples with the port's (L, L) bond-mask arrays as the JAX
    package's lists of rows."""
    return [{k: v.tolist() if isinstance(v, np.ndarray) else v
             for k, v in ex.items()} for ex in examples]


def _batch(n, seed, rows, bond_mask):
    """`n` examples collated into `rows` rows at L: the rest are the
    collator's dummy rows (every key masked, every label ignored)."""
    collate = port_data.Collator(ExperimentConfig(**EXPERIMENT), 0, 0)
    return collate(_examples(n, seed, bond_mask), fixed_batch=rows,
                   fixed_enc_len=L).arrays


def _random_params(module, batch, seed=0):
    shapes = jax.eval_shape(
        lambda b: module.init(jax.random.PRNGKey(0), b["input_ids"],
                              b["attention_mask"], b["atom_indices"],
                              b["bond_pairs"]), batch)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return jnp.asarray(1.0 + 0.1 * noise if path[-1].key == "scale"
                           else 0.05 * noise)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_inputs(batch):
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    return dict(input_ids=b["input_ids"], attention_mask=b["attention_mask"],
                atom_indices=b["atom_indices"], bond_pairs=b["bond_pairs"])


def _torch_inputs(batch):
    b = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    return dict(input_ids=b["input_ids"], attention_mask=b["attention_mask"],
                atom_indices=b["atom_indices"], bond_pairs=b["bond_pairs"])


class Pair:
    """The two packages' template models with the same weights."""

    def __init__(self, bond_mask, dtype="float32"):
        kw = dict(EXPERIMENT, unattend_nonbonds=bond_mask,
                  compute_dtype=dtype)
        self.jcfg = jax_config.ExperimentConfig(**kw)
        self.cfg = ExperimentConfig(**kw)
        enc = _enc_config()
        jdt, tdt = {"float32": (jnp.float32, torch.float32),
                    "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
        self.jmodule = JaxTemplateModel(encoder_config=enc,
                                        num_atom_templates=N_A,
                                        num_bond_templates=N_B, dtype=jdt)
        self.batch = _batch(3, seed=0, rows=4, bond_mask=bond_mask)
        self.params = _random_params(
            self.jmodule, {k: jnp.asarray(v) for k, v in self.batch.items()})
        self.module = TemplateBasedModel(
            TransformerConfig(**dataclasses.asdict(enc)), N_A, N_B,
            dtype=tdt)
        keys = self.module.load_state_dict(from_flax(jax.device_get(
            self.params)))
        assert not keys.missing_keys and not keys.unexpected_keys
        self.tx = jax_optim.make_optimizer(self.jcfg, NUM_STEPS)
        self.optimizer = make_optimizer(self.cfg, NUM_STEPS,
                                        self.module.named_parameters())

    def logits(self):
        """Both packages' logits on `self.batch`, computed once: the JAX
        side's Pallas kernels run in interpret mode, seconds a call."""
        if not hasattr(self, "_logits"):
            jout = self.jmodule.apply(self.params, **_jax_inputs(self.batch),
                                      deterministic=True)
            with torch.no_grad():
                tout = self.module(**_torch_inputs(self.batch))
            self._logits = ([np.asarray(x, np.float32)
                             for x in jout["logits"]],
                            [x.float().numpy() for x in tout["logits"]])
        return self._logits


@functools.lru_cache(maxsize=None)
def shared_pair(bond_mask):
    """One f32 Pair a mask for the module's tests that leave its weights
    as they are."""
    return Pair(bond_mask=bond_mask)


@pytest.fixture(scope="module", params=["bond_mask", "key_mask"])
def pair(request):
    return shared_pair(request.param == "bond_mask")


# --- (a) logits --------------------------------------------------------------

def test_template_logits_match_jax(pair):
    (ja, jb), (ta, tb) = pair.logits()
    B, A, MB = pair.batch["atom_indices"].shape + \
        pair.batch["bond_pairs"].shape[1:2]
    assert ta.shape == ja.shape == (4, A, N_A + 1)
    assert tb.shape == jb.shape == (4, MB, N_B + 1)
    np.testing.assert_allclose(ta, ja, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tb, jb, rtol=RTOL, atol=ATOL)
    assert pair.batch["attention_mask"].ndim == (
        3 if pair.cfg.unattend_nonbonds else 2)


def test_bond_mask_changes_the_logits():
    """The 2-D mask reaches the attention: the same weights and tokens give
    other logits with and without it."""
    masked, plain = shared_pair(True), shared_pair(False)
    _, (ta, _) = masked.logits()
    _, (pa, _) = plain.logits()
    assert np.abs(ta - pa).max() > 1e-3


# --- (b) loss, gradients, three steps ---------------------------------------

def test_template_loss_and_every_gradient_match_jax(pair):
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()}
    jloss_fn = jax_step.make_loss_fn(pair.jmodule, pair.jcfg, 0)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jloss_fn, has_aux=True))(pair.params, jbatch, jax.random.PRNGKey(0))
    pair.module.train()
    pair.module.zero_grad()
    tbatch = {k: torch.as_tensor(v).long() for k, v in pair.batch.items()}
    loss, metrics = make_loss_fn(pair.module, pair.cfg, 0)(
        tbatch, torch.Generator().manual_seed(0))
    loss.backward()
    assert set(metrics) == set(jmetrics) == {"train_loss"}
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL,
                               atol=ATOL)
    ref = grads_from_flax(jax.device_get(jgrads))
    named = dict(pair.module.named_parameters())
    assert set(ref) == set(named)
    assert {"head.atom_head.weight", "head.bond_head_left.bias",
            "head.bond_head_right.weight"} <= set(named)
    assert "head.bond_head_right.bias" not in named
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   rtol=1e-4, atol=2e-5, err_msg=name)
    pair.module.zero_grad()
    pair.module.eval()


@pytest.mark.parametrize("bond_mask", [True, False],
                         ids=["bond_mask", "key_mask"])
def test_three_accumulated_template_steps_match_jax(bond_mask):
    pair = Pair(bond_mask=bond_mask)
    real = [_batch(2, seed=s, rows=2, bond_mask=bond_mask) for s in (1, 2)]
    micro = {k: np.stack([real[0][k], real[1][k]]) for k in real[0]}
    weights = np.ones(2, np.float32)
    state = jax_step.TrainState.create(pair.params, pair.tx)
    jstep = jax_step.make_accum_train_step(pair.jmodule, pair.jcfg, pair.tx,
                                           0)
    tstate = TrainState.create(pair.module, pair.optimizer)
    tstep = make_accum_train_step(pair.module, pair.cfg, pair.optimizer, 0,
                                  device="cpu")
    jmicro = {k: jnp.asarray(v) for k, v in micro.items()}
    seen = []
    for i in range(3):
        state, jm = jstep(state, jmicro, jnp.asarray(weights),
                          jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, micro, weights, 0)
        assert set(tm) == set(jm) == {"train_loss", "grad_norm"}
        for key in tm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{key} step {i}")
        seen.append(float(tm["train_loss"]))
    assert tstate.step == 3 and seen[2] < seen[0]
    # AdamW divides by sqrt(v) + eps: where a gradient is within rounding
    # of 0 the two updates may differ by a fraction of the rate (1e-3)
    ref = from_flax(jax.device_get(state.params))
    for name, p in pair.module.named_parameters():
        diff = float((p.detach() - ref[name]).abs().max())
        assert diff <= 5e-5, (name, diff)


# --- (c) eval step and edit ranking -----------------------------------------

def test_template_eval_step_matches_jax(pair):
    k = 40
    batch = _batch(3, seed=4, rows=4, bond_mask=pair.cfg.unattend_nonbonds)
    jout = jax_step.make_eval_step(pair.jmodule, pair.jcfg, 0, edit_topk=k)(
        pair.params, {key: jnp.asarray(v) for key, v in batch.items()})
    tout = make_eval_step(pair.module, pair.cfg, 0, edit_topk=k,
                          device="cpu")(batch)
    assert set(tout) == set(jout) == {
        "example_mask", "indices", "loss", "atom_topk_vals", "atom_topk_idx",
        "bond_topk_vals", "bond_topk_idx"}
    np.testing.assert_allclose(tout["loss"].numpy(), np.asarray(jout["loss"]),
                               rtol=RTOL, atol=ATOL)
    for key in ("atom_topk_vals", "bond_topk_vals"):
        assert tout[key].shape == jout[key].shape
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   rtol=0, atol=1e-6, err_msg=key)
    # the device ranking merged on the host is the host ranking of the
    # same probabilities (reference utils.py:79-108), ties included
    with torch.no_grad():
        atom_logits, bond_logits = pair.module(
            **_torch_inputs(batch))["logits"]
    labels = {key: torch.as_tensor(batch[key]).long() for key in
              ("atom_template_labels", "bond_template_labels")}
    a_probs = losses.masked_probs(atom_logits,
                                  labels["atom_template_labels"]).numpy()
    b_probs = losses.masked_probs(bond_logits,
                                  labels["bond_template_labels"]).numpy()
    n_bonds = batch["bond_mask"].sum(1)
    examples = _examples(3, seed=4, bond_mask=False)
    for b in range(3):
        bonds = examples[b]["bonds"]
        assert len(bonds) == n_bonds[b]
        got = edits_from_topk(
            *(tout[key][b].numpy() for key in ("atom_topk_vals",
                                               "atom_topk_idx",
                                               "bond_topk_vals",
                                               "bond_topk_idx")),
            N_A + 1, N_B + 1, bonds, top_num=k)
        assert got == rank_edits(a_probs[b], b_probs[b], bonds, top_num=k)


def _planted_ties(seed, B=3, A=16, MB=24):
    """Probabilities on a grid of eighths (so values tie everywhere), some
    atom rows and bond rows zero, padded bond rows."""
    rng = np.random.default_rng(seed)
    atom = rng.integers(0, 4, (B, A, N_A + 1)).astype(np.float32) / 8
    atom[:, A - 5:] = 0.0
    bond = rng.integers(0, 4, (B, MB, N_B + 1)).astype(np.float32) / 8
    valid = np.ones((B, MB), np.int32)
    valid[0, 10:] = 0
    valid[2, :] = 0
    return atom, bond, valid


@pytest.mark.parametrize("k", [1, 7, 64, 500])
@pytest.mark.parametrize("seed", [0, 1])
def test_device_topk_edits_equal_jax_with_ties(seed, k):
    atom, bond, valid = _planted_ties(seed)
    ref = jax_device_topk_edits(jnp.asarray(atom), jnp.asarray(bond),
                                jnp.asarray(valid), k)
    got = device_topk_edits(torch.from_numpy(atom), torch.from_numpy(bond),
                            torch.from_numpy(valid), k)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # ties: equal values appear with the larger flat index first
    vals, idx = got[0].numpy(), got[1].numpy()
    tied = vals[:, 1:] == vals[:, :-1]
    if k > 1:
        assert tied.any() and (idx[:, 1:] < idx[:, :-1])[tied].all()


def test_host_edit_ranking_is_a_copy():
    """`edits_from_topk` and `rank_edits`, the host halves, give the JAX
    package's edits and probabilities on the planted ties."""
    import textreact_tpu.evaluation.edit_rank as jer
    atom, bond, valid = _planted_ties(3)
    top = [t.numpy() for t in device_topk_edits(
        torch.from_numpy(atom), torch.from_numpy(bond),
        torch.from_numpy(valid), 50)]
    for b in range(3):
        pairs = [(j, j + 1) for j in range(int(valid[b].sum()))]
        for top_num in (None, 1, 20):
            assert rank_edits(atom[b], bond[b], pairs, top_num) \
                == jer.rank_edits(atom[b], bond[b], pairs, top_num)
        assert edits_from_topk(*(t[b] for t in top), N_A + 1, N_B + 1,
                               pairs, 50) \
            == jer.edits_from_topk(*(t[b] for t in top), N_A + 1, N_B + 1,
                                   pairs, 50)


# --- (d) dataset and collator ------------------------------------------------

PRODUCTS = ["CC(=O)Oc1ccccc1C(=O)O", "O=C1CCCN1", "CCOC(=O)c1ccc(N)cc1",
            "C", "Brc1ccc2[nH]ccc2c1", "CC(C)(C)OC(=O)N1CCC(CO)CC1"]


def _write_rows(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _write_template_data(root, products, seed=0):
    """A split per name with canonical bond sets (the empty set written as
    'set()', as the processor writes it), a shuffled ProductAtomIdx2CanonIdx
    and random atom and bond labels."""
    os.makedirs(root, exist_ok=True)
    rng = random.Random(seed)
    _write_rows(os.path.join(root, "atom_templates.csv"),
                ["Template", "Frequency", "Class"],
                [[f"[T{i}]>>[U{i}]", 10 - i, i + 1] for i in range(4)])
    _write_rows(os.path.join(root, "bond_templates.csv"),
                ["Template", "Frequency", "Class"],
                [[f"[B{i}]>>[V{i}]", 9 - i, i + 1] for i in range(3)])
    for split in ("train", "val", "test"):
        rows, pre = [], []
        for i, prod in enumerate(products):
            mol = parse_smiles(prod)
            n = len(mol.atoms)
            bonds = {p for b in mol.bonds for p in ((b.a1, b.a2),
                                                    (b.a2, b.a1))}
            a2c = list(range(n))
            rng.shuffle(a2c)
            labels = [("a", rng.randrange(n), rng.randrange(1, 5))]
            if bonds:
                a1, a2 = rng.choice(sorted(bonds))
                labels.append(("b", (a2c.index(a1), a2c.index(a2)),
                               rng.randrange(1, 4)))
            rows.append([f"{split}{i}", prod, prod + ".O"])
            pre.append([repr(labels), repr(a2c),
                        repr(bonds) if bonds else "set()"])
        _write_rows(os.path.join(root, f"{split}.csv"),
                    ["id", "product_smiles", "reactant_smiles"], rows)
        _write_rows(os.path.join(root, f"preprocessed_{split}.csv"),
                    ["Labels", "ProductAtomIdx2CanonIdx",
                     "ProductCanonBonds"], pre)
    return root


DATASET_MODES = {
    "plain": {}, "shuffle_smiles": dict(shuffle_smiles=True),
    "bond_mask": dict(unattend_nonbonds=True),
    "shuffle_bond_mask_mlm": dict(shuffle_smiles=True, unattend_nonbonds=True,
                                  mlm=True, mlm_ratio=0.15)}


@pytest.fixture(scope="module")
def template_root(tmp_path_factory):
    return _write_template_data(str(tmp_path_factory.mktemp("tpl")),
                                PRODUCTS)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("mode", list(DATASET_MODES))
def test_template_dataset_and_collator_match_jax(template_root, split, mode):
    kw = dict(task="retro", template_based=True, template_path=template_root,
              encoder_tokenizer="smiles", num_neighbors=-1, max_length=64,
              length_buckets=(64,), **DATASET_MODES[mode])
    jcfg = jax_config.ExperimentConfig(**kw)
    pcfg = ExperimentConfig(**kw)
    jenc, jdec = jax_tok.get_tokenizers(jcfg)
    penc, pdec = port_tok.get_tokenizers(pcfg)
    assert pdec.atom_templates == jdec.atom_templates
    assert pdec.num_bond_templates == jdec.num_bond_templates == 3
    path = os.path.join(template_root, f"{split}.csv")
    a = jax_data.RetrosynthesisDataset(jcfg, path, jenc, jdec, split=split)
    b = port_data.RetrosynthesisDataset(pcfg, path, penc, pdec, split=split)
    assert len(a) == len(b) == len(PRODUCTS)
    augment = split == "train"
    for epoch in (0, 1):
        exa = [a.example(i, random.Random(epoch * 100 + i), augment)
               for i in range(len(a))]
        exb = [b.example(i, random.Random(epoch * 100 + i), augment)
               for i in range(len(b))]
        assert as_lists(exb) == exa
        if "mlm" not in kw and "shuffle_smiles" in kw and augment:
            # the atom positions are shifted past [CLS] and follow the
            # permutation: each names its own atom's token
            for ex, prod in zip(exb, PRODUCTS):
                tokens = penc.convert_ids_to_tokens(ex["input_ids"])
                for atom, p in zip(parse_smiles(prod).atoms,
                                   ex["atom_indices"]):
                    assert atom.symbol.lower() in tokens[p].lower(), (
                        prod, tokens[p], atom.symbol)
        for static in (False, True):
            ca = jax_data.Collator(jcfg, jenc.pad_token_id, 0,
                                   static_shapes=static)(exa, fixed_batch=8)
            cb = port_data.Collator(pcfg, penc.pad_token_id, 0,
                                    static_shapes=static)(exb, fixed_batch=8)
            assert set(ca.arrays) == set(cb.arrays)
            assert {"atom_indices", "atom_mask", "bond_pairs", "bond_mask",
                    "atom_template_labels",
                    "bond_template_labels"} <= set(cb.arrays)
            for name, arr in ca.arrays.items():
                assert arr.dtype == cb.arrays[name].dtype, name
                np.testing.assert_array_equal(arr, cb.arrays[name],
                                              err_msg=name)
            assert ca.host == cb.host
            mask = cb.arrays["attention_mask"]
            assert mask.ndim == (3 if pcfg.unattend_nonbonds else 2)
    if pcfg.unattend_nonbonds and not pcfg.mlm:
        # a non-bonded atom pair of the first product cannot attend (under
        # MLM the mask keeps the unreordered positions, in both packages)
        ex = exb[0]
        pos = ex["atom_indices"]
        assert ex["attention_mask"][pos[0], pos[0]] == 1
        bonded = {tuple(p) for p in ex["bonds"]}
        far = next(j for j in range(1, len(pos)) if (0, j) not in bonded)
        assert ex["attention_mask"][pos[0], pos[far]] == 0


# --- (e) the trainer twin ----------------------------------------------------

ESTER = ("[C:1](=[O:2])-[O;H0;D2;+0:3]>>"
         "[C:1](=[O:2])-[OH;D1;+0:4].[OH;D1;+0:3]")
ESTER_INFO = {"edit_site": {"B": [(1, 3)]},
              "change_H": {1: 0, 2: 0, 3: 1},
              "change_C": {1: 0, 2: 0, 3: 0},
              "change_S": {1: 0, 2: 0, 3: 0}}
ESTERS = ["CCOC(C)=O", "COC(C)=O", "CCOC(=O)CC", "COC(=O)CC",
          "CCCOC(C)=O", "CCOC(=O)C(C)C"]
TINY_ENC = {"vocab_size": 700, "hidden_size": 32, "num_hidden_layers": 2,
            "num_attention_heads": 4, "intermediate_size": 64,
            "max_position_embeddings": 96, "type_vocab_size": 1,
            "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}


def write_ester_data(root):
    """The fixture of tests/test_template_e2e.py's full cycle: esters
    labelled at their ester bond with a real hydrolysis template, whose
    decode gives the gold reactants; dropout 0 in the encoder config."""
    from textreact_tpu_torch.chem.smarts import find_matches, parse_smarts
    from textreact_tpu_torch.evaluation._own_template_apply import \
        apply_ranked_edits
    os.makedirs(root, exist_ok=True)
    for name in ("atom_templates.csv", "bond_templates.csv"):
        _write_rows(os.path.join(root, name), ["Template", "Frequency",
                                               "Class"], [[ESTER, 10, 1]])
    _write_rows(os.path.join(root, "template_infos.csv"),
                ["Template", "edit_site", "change_H", "change_C",
                 "change_S"],
                [[ESTER] + [repr(ESTER_INFO[k]) for k in
                            ("edit_site", "change_H", "change_C",
                             "change_S")]])
    pattern = parse_smarts("[C:1](=[O:2])-[O;H0;D2;+0:3]")
    rng = random.Random(0)
    for split, n in [("train", 16), ("val", 6), ("test", 6)]:
        rows, pre = [], []
        for i in range(n):
            prod = ESTERS[rng.randrange(len(ESTERS))]
            mol = parse_smiles(prod)
            m = find_matches(pattern, mol)[0]
            site = (m[0], m[2])
            gold = apply_ranked_edits([("b", site, 1, 1.0)], prod, {},
                                      {1: ESTER}, {ESTER: ESTER_INFO}, 1)[0]
            bonds = sorted({p for b in mol.bonds
                            for p in ((b.a1, b.a2), (b.a2, b.a1))})
            rows.append([f"F{split}{i}", prod, gold])
            pre.append([repr([("b", site, 1)]),
                        repr(list(range(len(mol.atoms)))), repr(bonds)])
        _write_rows(os.path.join(root, f"{split}.csv"),
                    ["id", "product_smiles", "reactant_smiles"], rows)
        _write_rows(os.path.join(root, f"preprocessed_{split}.csv"),
                    ["Labels", "ProductAtomIdx2CanonIdx",
                     "ProductCanonBonds"], pre)
    with open(os.path.join(root, "enc.json"), "w") as f:
        json.dump(TINY_ENC, f)
    return root


def _ester_cfg(root, save, **kw):
    base = dict(task="retro", template_based=True, unattend_nonbonds=True,
                do_train=True, do_test=True, data_path=root,
                template_path=root, train_file="train.csv",
                valid_file="val.csv", test_file="test.csv",
                encoder=os.path.join(root, "enc.json"),
                encoder_tokenizer="smiles", num_neighbors=-1, max_length=64,
                batch_size=8, test_batch_size=8, epochs=2, lr=3e-3,
                eval_per_epoch=1, num_beams=20, compute_dtype="float32",
                log_every=1, length_buckets=(64,), debug=True,
                save_path=os.path.join(root, save))
    base.update(kw)
    return base


def test_template_trainer_twin_matches_jax(tmp_path):
    from textreact_tpu.train.trainer import Trainer as JaxTrainer
    from textreact_tpu_torch.train.trainer import Trainer
    root = write_ester_data(str(tmp_path / "data"))
    jtrainer = JaxTrainer(jax_config.ExperimentConfig(
        **_ester_cfg(root, "out_jax")))
    ptrainer = Trainer(ExperimentConfig(**_ester_cfg(root, "out_port")),
                       device="cpu")
    # both trainers start from the same weights: the JAX trainer's initial
    # parameters, drawn once under jit (eager, its init takes seconds of
    # op-by-op compiles) and given back to its fit()
    params = jax.jit(jtrainer._init_params)()
    jtrainer._init_params = lambda: params
    keys = ptrainer.module.load_state_dict(
        from_flax(jax.device_get(params)))
    assert not keys.missing_keys and not keys.unexpected_keys
    results = []
    for t in (jtrainer, ptrainer):
        t.prepare_data()
        t.fit()
        results.append(t.test())
    rows = []
    for t in (jtrainer, ptrainer):
        with open(os.path.join(t.cfg.save_path, "metrics.jsonl")) as f:
            rows.append([json.loads(line) for line in f])
    jtrain, ptrain = ([r for r in rr if "train_loss" in r] for rr in rows)
    assert [r["step"] for r in jtrain] == [r["step"] for r in ptrain] \
        == [1, 2, 3, 4]
    for a, b in zip(jtrain, ptrain):
        for key in ("train_loss", "grad_norm"):
            assert abs(a[key] - b[key]) <= 1e-4, (key, a, b)
    jval, pval = ([r["val_acc"] for r in rr if "val_acc" in r]
                  for rr in rows)
    assert len(jval) == 2 and pval == jval
    preds = []
    for t in (jtrainer, ptrainer):
        with open(os.path.join(t.cfg.save_path,
                               "prediction_test_0.json")) as f:
            preds.append(json.load(f))
    assert preds[0].keys() == preds[1].keys() and len(preds[1]) == 6
    for key, a in preds[0].items():
        b = preds[1][key]
        assert b["prediction"] == a["prediction"], key
        assert b["raw_template_labels"] == a["raw_template_labels"]
        assert b["top1_template_match"] == a["top1_template_match"]
        np.testing.assert_allclose(b["score"], a["score"], rtol=0, atol=1e-5)
    assert results[1] == results[0] and len(results[1]) == 1
    assert set(results[1][0]) == {1, 2, 3, 5, 10, 20}
    assert results[1][0][20] >= 0.5, results


def test_template_decode_pool_gives_the_in_process_decode(tmp_path):
    """The decode's spawned pool, which takes a worker for every
    _PRODUCTS_PER_WORKER products, returns what the decode in this process
    returns, in order: the ester fixture's products under their gold edit
    and under a ranking that holds the gold edit at rank 2."""
    import textreact_tpu_torch.evaluation.template_decode as td
    from textreact_tpu_torch.utils.table import Table, read_csv
    root = write_ester_data(str(tmp_path / "data"))
    table = read_csv(os.path.join(root, "train.csv"))
    labels = read_csv(os.path.join(root, "preprocessed_train.csv"))["Labels"]
    n = 2 * td._PRODUCTS_PER_WORKER
    rows = [i % len(table) for i in range(n)]
    data = Table({k: [v[i] for i in rows] for k, v in table.columns.items()})
    prediction = {}
    for j, i in enumerate(rows):
        gold = tuple(ast.literal_eval(labels[i])[0])
        edits = [gold] if j % 2 else [("b", (0, 1), 1), gold]
        prediction[j] = {"prediction": edits,
                         "score": [1.0 / (k + 1) for k in range(len(edits))]}
    alone = td.decode_template_predictions(prediction, data, root, 3)
    pooled = td.decode_template_predictions(prediction, data, root, 3,
                                            num_workers=4)
    assert pooled == alone
    assert alone == [[gold] for gold in data["reactant_smiles"]]


def test_template_cli_runs_on_the_cpu(tmp_path, capsys):
    """python -m textreact_tpu_torch --task retro --template_based
    --unattend_nonbonds --device cpu: train, validate and test."""
    from textreact_tpu_torch.cli.main import main
    root = write_ester_data(str(tmp_path / "data"))
    save = tmp_path / "run"
    accuracies = main([
        "--task", "retro", "--template_based", "--unattend_nonbonds",
        "--do_train", "--do_valid", "--do_test", "--data_path", root,
        "--template_path", root, "--train_file", "train.csv",
        "--valid_file", "val.csv", "--test_file", "test.csv",
        "--encoder", os.path.join(root, "enc.json"),
        "--encoder_tokenizer", "smiles", "--num_neighbors", "-1",
        "--max_length", "64", "--batch_size", "8", "--test_batch_size", "8",
        "--epochs", "1", "--lr", "3e-3", "--num_beams", "20",
        "--compute_dtype", "float32", "--save_path", str(save),
        "--log_every", "1", "--debug", "--device", "cpu"])
    records = [json.loads(line)
               for line in (save / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "train_loss" in r] == [1, 2]
    assert len([r for r in records if "val_acc" in r]) == 1
    preds = json.loads((save / "prediction_test_0.json").read_text())
    assert len(preds) == 6 and all(p["prediction"] for p in preds.values())
    assert len(accuracies) == 1 and set(accuracies[0]) == {1, 2, 3, 5, 10,
                                                           20}
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert json.loads(printed[-1]) == {str(k): v for k, v in
                                       accuracies[0].items()}


# --- (f) bfloat16 ------------------------------------------------------------

# bf16 compute on both sides, the same converted f32 weights. The two
# encoders round at different points in two places, each one bf16 ulp apart
# where they differ: flax's Dense(dtype=bf16) rounds x @ W to bf16 before it
# adds the bias and rounds again, the port's `Linear` rounds the sum once
# (27% of outputs differ); XLA's CPU backend evaluates the tanh GELU op by op
# in bf16, torch in f32 with one rounding (40% differ). One block fed the
# same bf16 input ends with 38% of its outputs one ulp apart (up to 2^-5 at
# |x| ~ 5). Through two layers and f32 heads of std 0.05 that leaves logits
# of order 1 at most 0.0103 apart, and losses 9e-4 apart: the bounds below
# are twice and five times that.
BF16_LOGIT_TOL, BF16_LOSS_TOL = 2e-2, 5e-3
# the heads alone on the same bf16 states, f32 on both sides: summation
# order over 128 terms
HEAD_TOL = 1e-4


@pytest.mark.parametrize("bond_mask", [True, False],
                         ids=["bond_mask", "key_mask"])
def test_bf16_logits_and_loss_match_jax(bond_mask):
    pair = Pair(bond_mask=bond_mask, dtype="bfloat16")
    (ja, jb), (ta, tb) = pair.logits()
    for t, j in ((ta, ja), (tb, jb)):
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0, atol=BF16_LOGIT_TOL)
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()}
    jloss, _ = jax_step.make_loss_fn(pair.jmodule, pair.jcfg, 0)(
        pair.params, jbatch, jax.random.PRNGKey(0))
    tbatch = {k: torch.as_tensor(v).long() for k, v in pair.batch.items()}
    pair.module.train()
    with torch.no_grad():
        tloss, _ = make_loss_fn(pair.module, pair.cfg, 0)(
            tbatch, torch.Generator().manual_seed(0))
    pair.module.eval()
    assert abs(float(tloss) - float(jloss)) <= BF16_LOSS_TOL


def _bf16_head_inputs(seed=5, B=3, A=24, MB=40, d=128):
    """bf16 atom states (exactly representable, |x| ~ 1) and heads of unit
    weights whose f32 bits bf16 drops: the f32 heads keep them, bf16 heads
    round each weight (2^-9 relative) and the logits (order 10-50, a bf16
    ulp up to 2^-2). Measured: f32 heads 1.5e-5 from the JAX heads, bf16
    heads 0.13-0.17."""
    rng = np.random.default_rng(seed)
    states = rng.standard_normal((B, A, d)).astype(np.float32)
    states = np.array(jnp.asarray(states, jnp.bfloat16).astype(jnp.float32))
    pairs = rng.integers(0, A, (B, MB, 2)).astype(np.int32)
    weights = {name: rng.standard_normal((d, n)).astype(np.float32)
               for name, n in (("atom_head", N_A + 1),
                               ("bond_head_left", N_B + 1),
                               ("bond_head_right", N_B + 1))}
    params = {"params": {
        "atom_head": {"kernel": weights["atom_head"],
                      "bias": rng.standard_normal(N_A + 1).astype(np.float32)},
        "bond_head_left": {"kernel": weights["bond_head_left"],
                           "bias": rng.standard_normal(N_B + 1).astype(
                               np.float32)},
        "bond_head_right": {"kernel": weights["bond_head_right"]}}}
    return states, pairs, params


@pytest.mark.parametrize("heads", ["f32", "bf16"])
def test_bf16_head_cast_point_is_told_from_rounding_noise(heads, monkeypatch):
    """The JAX heads are nn.Dense(dtype=float32) (encdec.py:131-138): bf16
    atom states are promoted and multiplied in f32. The port's heads on the
    same bf16 states meet HEAD_TOL; heads computed in bf16 (the port's
    `Linear` would do that) miss it by two orders of magnitude on the same
    inputs, so the check tells a wrong cast point from rounding noise."""
    states, pairs, params = _bf16_head_inputs()
    jhead = JaxTemplateHead(128, N_A, N_B, dtype=jnp.bfloat16)
    ja, jb = jhead.apply(jax.tree.map(jnp.asarray, params),
                         jnp.asarray(states, jnp.bfloat16),
                         jnp.asarray(pairs))
    assert ja.dtype == jnp.float32
    head = TemplateHead(128, N_A, N_B)
    head.load_state_dict(from_flax(params))
    if heads == "bf16":
        def bf16_dense(layer, x):
            bias = None if layer.bias is None else layer.bias.bfloat16()
            return torch.nn.functional.linear(
                x.bfloat16(), layer.weight.bfloat16(), bias).float()
        monkeypatch.setattr(TemplateHead, "_dense", staticmethod(bf16_dense))
    with torch.no_grad():
        ta, tb = head(torch.from_numpy(states).bfloat16(),
                      torch.from_numpy(pairs))
    assert ta.dtype == torch.float32
    err = max(float(np.abs(ta.numpy() - np.asarray(ja)).max()),
              float(np.abs(tb.numpy() - np.asarray(jb)).max()))
    if heads == "f32":
        assert err <= HEAD_TOL, err
    else:
        assert err > 100 * HEAD_TOL, err
