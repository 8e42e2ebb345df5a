"""The port's own copies of the host-side modules against the JAX
package's originals: copies drift, so the same inputs must give the same
token ids, masked sequences and collated arrays."""

import dataclasses
import json
import os
import random

import numpy as np
import pytest

import textreact_tpu.config as jax_config
import textreact_tpu.data.collate as jax_collate
import textreact_tpu.data.mlm as jax_mlm
import textreact_tpu.tokenizers as jax_tok
import textreact_tpu_torch.config as port_config
import textreact_tpu_torch.data as port_data
import textreact_tpu_torch.tokenizers as port_tok
from fixtures import write_text_vocab

SMILES = ["CC(=O)Cl.OCc1ccccc1>>CC(=O)OCc1ccccc1",
          "Brc1ccccc1.OB(O)c1ccccc1>>c1ccc(-c2ccccc2)cc1",
          "[Na+].[Cl-].C[C@H](N)C(=O)O>>C[C@@H](N)C(=O)OC",
          "c1ccc2[nH]ccc2c1%12"]
TEXTS = ["The mixture was stirred at room temperature for 2 h.",
         "Pd(PPh3)4 (5 mol%) and K2CO3 in THF/H2O; yield 85 %",
         "naïve café µ-wave heating, 100 °C", ""]


def _cfgs(tmp_path, **kw):
    vocab = tmp_path / "vocab.txt"
    write_text_vocab(str(vocab))
    kw = dict(text_vocab_file=str(vocab), max_length=64, max_dec_length=16,
              **kw)
    return jax_config.ExperimentConfig(**kw), port_config.ExperimentConfig(**kw)


def test_experiment_config_has_the_same_fields_and_defaults():
    a = {f.name: f.default for f in dataclasses.fields(
        jax_config.ExperimentConfig)}
    b = {f.name: f.default for f in dataclasses.fields(
        port_config.ExperimentConfig)}
    assert a == b
    for n in (1, 64, 65, 600):
        assert port_config.bucket_length(n, (64, 128, 512)) \
            == jax_config.bucket_length(n, (64, 128, 512))


def test_bundled_vocabularies_are_the_same_files():
    for name in ("CONDITION_VOCAB", "SMILES_VOCAB"):
        a, b = getattr(jax_tok, name), getattr(port_tok, name)
        assert a != b and "textreact_tpu_torch" in b
        assert open(a).read() == open(b).read()


@pytest.mark.parametrize("mode", ["smiles", "text", "smiles_text"])
@pytest.mark.parametrize("task", ["condition", "retro"])
def test_tokenizers_give_the_same_ids(tmp_path, mode, task):
    jcfg, pcfg = _cfgs(tmp_path, encoder_tokenizer=mode, task=task)
    jenc, jdec = jax_tok.get_tokenizers(jcfg)
    penc, pdec = port_tok.get_tokenizers(pcfg)
    assert len(jenc) == len(penc) and len(jdec) == len(pdec)
    for attr in ("pad_token_id", "mask_token_id"):
        assert getattr(jenc, attr) == getattr(penc, attr)
    for smi in SMILES:
        for text in TEXTS:
            pair = [text, TEXTS[0]] if mode != "smiles" else None
            if mode == "smiles":
                assert jenc(smi) == penc(smi)
            else:
                assert jenc(smi, text_pair=pair) == penc(smi, text_pair=pair)
    if task == "condition":
        conds = ["", "ClCCl", "not-in-vocab", "CCN(CC)CC", "O"]
        assert jdec(conds) == pdec(conds)
        ids = jdec(conds)["input_ids"]
        assert jdec.decode(ids, True) == pdec.decode(ids, True)
        assert (jdec.bos_token_id, jdec.eos_token_id) \
            == (pdec.bos_token_id, pdec.eos_token_id)
    else:
        for smi in SMILES:
            assert jdec(smi) == pdec(smi)
            ids = jdec(smi)["input_ids"]
            assert jdec.decode(ids) == pdec.decode(ids)


def test_template_based_tokenizers_wait_for_their_slice(tmp_path):
    """The template branch of get_tokenizers, which raised until its slice:
    the SMILES encoder tokenizer and the template tables as the decoder's,
    equal to the JAX package's."""
    from test_torch_template import PRODUCTS, _write_template_data
    root = _write_template_data(str(tmp_path / "tpl"), PRODUCTS)
    jcfg, pcfg = _cfgs(tmp_path, encoder_tokenizer="smiles", task="retro",
                       template_based=True, template_path=root)
    (jenc, jdec), (penc, pdec) = (jax_tok.get_tokenizers(jcfg),
                                  port_tok.get_tokenizers(pcfg))
    assert penc(PRODUCTS[0]) == jenc(PRODUCTS[0])
    assert isinstance(pdec, port_data.TemplateTables)
    assert (pdec.atom_templates, pdec.bond_templates) \
        == (jdec.atom_templates, jdec.bond_templates)
    assert (pdec.num_atom_templates, pdec.num_bond_templates) == (4, 3)
    assert pdec.atom_template(1) == jdec.atom_template(1) == "[T0]>>[U0]"
    with pytest.raises(ValueError, match="smiles encoder"):
        port_tok.get_tokenizers(dataclasses.replace(
            pcfg, encoder_tokenizer="text"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_span_mlm_and_reorder_match(seed):
    ids = list(np.random.default_rng(seed).integers(5, 90, 70))
    a = jax_mlm.apply_span_mlm(ids, 4, 0.15, rng=random.Random(seed))
    b = port_data.apply_span_mlm(ids, 4, 0.15, rng=random.Random(seed))
    assert a == b and len(b[2]) > 0
    new_ids, position_ids, labels = b
    assert new_ids[:len(labels)] == [4] * len(labels)
    assert sorted(position_ids) == list(range(len(ids)))
    assert port_data.remap_positions(position_ids, [3, 9]) \
        == jax_mlm.remap_positions(position_ids, [3, 9])
    assert port_data.reorder_masked_first(ids, [-100] * 70, 4) \
        == jax_mlm.reorder_masked_first(ids, [-100] * 70, 4)


def _examples(seed, n=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(20, 100))
        ids = [int(t) for t in rng.integers(5, 90, length)]
        new_ids, pos, labels = port_data.apply_span_mlm(
            ids, 4, 0.15, rng=random.Random(seed + i))
        dec = [1] + [int(t) for t in rng.integers(6, 40, 5)] + [2]
        out.append({"id": f"r{i}", "index": i, "input_ids": new_ids,
                    "attention_mask": [1] * length, "position_ids": pos,
                    "mlm_labels": labels, "decoder_input_ids": dec,
                    "decoder_attention_mask": [1] * len(dec)})
    return out


@pytest.mark.parametrize("static_shapes", [False, True])
def test_collator_gives_the_same_arrays(tmp_path, static_shapes):
    jcfg, pcfg = _cfgs(tmp_path)
    assert port_data.IGNORE_INDEX == jax_collate.IGNORE_INDEX == -100
    examples = _examples(0)
    a = jax_collate.Collator(jcfg, 0, 0, static_shapes=static_shapes)(
        examples, fixed_batch=8)
    b = port_data.Collator(pcfg, 0, 0, static_shapes=static_shapes)(
        examples, fixed_batch=8)
    assert set(a.arrays) == set(b.arrays) and a.host == b.host
    for name, arr in a.arrays.items():
        assert arr.dtype == b.arrays[name].dtype
        np.testing.assert_array_equal(arr, b.arrays[name], err_msg=name)
    assert b.size == 5 and b["mlm_labels"].shape[1] % 16 == 0
    assert "ids" in b and b["ids"][0] == "r0"


@pytest.mark.parametrize("bond_mask", [False, True])
@pytest.mark.parametrize("static_shapes", [False, True])
def test_collator_gives_the_same_template_arrays(tmp_path, static_shapes,
                                                 bond_mask):
    """The template fields of collate.py (reference dataset.py:362-380):
    atom positions and mask, bond pairs and mask, both label arrays, the
    (B, L, L) bond mask, bucketed and static shapes."""
    from test_torch_template import _examples as template_examples
    from test_torch_template import as_lists
    kw = dict(task="retro", template_based=True, template_path="x",
              max_length=128, length_buckets=(64, 128))
    jcfg = jax_config.ExperimentConfig(**kw)
    pcfg = port_config.ExperimentConfig(**kw)
    examples = template_examples(5, seed=1, bond_mask=bond_mask)
    a = jax_collate.Collator(jcfg, 0, 0, static_shapes=static_shapes)(
        as_lists(examples), fixed_batch=8)
    b = port_data.Collator(pcfg, 0, 0, static_shapes=static_shapes)(
        examples, fixed_batch=8)
    assert set(a.arrays) == set(b.arrays) == {
        "input_ids", "attention_mask", "atom_indices", "atom_mask",
        "bond_pairs", "bond_mask", "atom_template_labels",
        "bond_template_labels", "example_mask", "indices"}
    for name, arr in a.arrays.items():
        assert arr.dtype == b.arrays[name].dtype, name
        np.testing.assert_array_equal(arr, b.arrays[name], err_msg=name)
    assert a.host == b.host
    # the port's collator takes the JAX package's lists of rows as well
    c = port_data.Collator(pcfg, 0, 0, static_shapes=static_shapes)(
        as_lists(examples), fixed_batch=8)
    for name, arr in a.arrays.items():
        np.testing.assert_array_equal(arr, c.arrays[name], err_msg=name)
    L = b["input_ids"].shape[1]
    assert b["attention_mask"].shape == ((8, L, L) if bond_mask else (8, L))
    if static_shapes:
        assert L == 128 and b["atom_indices"].shape[1] == 128
        assert b["bond_pairs"].shape[1] == 256


# --- the retrieval slice's copies: chem kit, retrieval helpers, logging ---

def _public(module):
    return {n for n in dir(module) if not n.startswith("_")}


def _golden_smiles():
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "canon_groups.json")
    with open(path) as f:
        return [s for g in json.load(f)["groups"] for s in g["smiles"]]


CHEM_SMILES = [s.split(">>")[0] for s in SMILES[:3]] + [
    "c1ccc2[nH]ccc2c1", "F/C=C/F", "F/C=C\\F", "N[C@@H](C)C(=O)O",
    "[13CH4]", "[O-][N+](=O)c1ccccc1", "C1CC1C(=O)Cl", "not a smiles", ""]


def test_chem_kit_has_the_same_public_names():
    import textreact_tpu.chem as jax_chem
    import textreact_tpu_torch.chem as port_chem
    assert set(port_chem.__all__) == set(jax_chem.__all__)
    for name in ("mol", "canon", "aromatic", "rdkit_bridge"):
        a = __import__(f"textreact_tpu.chem.{name}", fromlist=["x"])
        b = __import__(f"textreact_tpu_torch.chem.{name}", fromlist=["x"])
        assert _public(a) == _public(b), name
    import textreact_tpu.chem.fingerprints as jfp
    import textreact_tpu_torch.chem.fingerprints as pfp
    assert _public(jfp) - _public(pfp) == set()
    assert _public(pfp) - _public(jfp) == set()


def _outcome(fn, *args):
    """The value, or the name of the exception's class."""
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__
    return out.tolist() if isinstance(out, np.ndarray) else out


@pytest.mark.parametrize("source", ["hard_cases", "goldens"])
def test_chem_kit_gives_the_same_outputs(source):
    import textreact_tpu.chem as jax_chem
    import textreact_tpu_torch.chem as port_chem
    smiles = CHEM_SMILES if source == "hard_cases" else _golden_smiles()
    assert len(smiles) >= 10

    def both(fn):
        return [(lambda *a, k=kit: fn(k, *a))
                for kit in (jax_chem, port_chem)]

    for s in smiles:
        for fn in (lambda k, x: k.canonical_smiles(x),
                   lambda k, x: k.canonical_smiles_strict(x),
                   lambda k, x: k.morgan_fingerprint(x),
                   lambda k, x: k.write_smiles(k.parse_smiles(x)),
                   lambda k, x: k.canonical_ranks(k.parse_smiles(x)),
                   lambda k, x: k.random_smiles(x, random.Random(3))):
            ref, got = (_outcome(f, s) for f in both(fn))
            assert got == ref, s
    assert _outcome(port_chem.canonical_smiles_strict, "not a smiles") \
        == "SmilesParseError"
    for rxn in SMILES + ["CCO>CC(=O)O>CCOC(C)=O", "CCO>>", "bad>>worse", ""]:
        for fn in (lambda k, x: k.canonical_rxn_smiles(x),
                   lambda k, x: k.reaction_difference_fingerprint(x)):
            ref, got = (_outcome(f, rxn) for f in both(fn))
            assert got == ref, rxn


@pytest.mark.parametrize("kind,n_bits", [("morgan", None), ("morgan", 512),
                                         ("reaction", None)])
def test_fingerprint_matrix_matches_in_process_and_in_workers(kind, n_bits):
    """Both packages take their C++ route (chem/native.py), the Python
    workers only when it is unavailable (JAX) or not asked for (the port's
    `native=False`); the routes are held identical to each other."""
    import textreact_tpu.chem as jax_chem
    import textreact_tpu_torch.chem as port_chem
    smiles = SMILES if kind == "reaction" else CHEM_SMILES
    ref = jax_chem.fingerprint_matrix(smiles, kind, n_bits)
    got = port_chem.fingerprint_matrix(smiles, kind, n_bits)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        port_chem.fingerprint_matrix(smiles, kind, n_bits, num_workers=2), ref)
    np.testing.assert_array_equal(
        port_chem.fingerprint_matrix(smiles, kind, n_bits, native=False), ref)


@pytest.mark.parametrize("path", ["tokenizers/_ctok.cpp", "chem/_cchem.cpp"])
def test_host_accelerator_sources_are_the_same_files(path):
    """The port builds its own copies of the JAX package's C++ accelerators:
    byte for byte, so the two cannot drift."""
    import textreact_tpu
    import textreact_tpu_torch
    a = os.path.join(os.path.dirname(textreact_tpu.__file__), path)
    b = os.path.join(os.path.dirname(textreact_tpu_torch.__file__), path)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_retrieval_helpers_and_logging_have_the_same_public_names():
    import textreact_tpu.retrieval as jax_retrieval
    import textreact_tpu.retrieval.convert as jconv
    import textreact_tpu.retrieval.fingerprints as jfp
    import textreact_tpu.utils.logging as jlog
    import textreact_tpu_torch.retrieval as port_retrieval
    import textreact_tpu_torch.retrieval.convert as pconv
    import textreact_tpu_torch.retrieval.fingerprints as pfp
    import textreact_tpu_torch.utils.logging as plog
    for a, b in ((jfp, pfp), (jconv, pconv), (jlog, plog)):
        assert _public(a) == _public(b), a.__name__
    # the mesh axis waits for the multi-GPU slice; merge_topk is its merge
    assert set(jax_retrieval.__all__) - set(port_retrieval.__all__) \
        == {"CORPUS_AXIS"}
    assert set(port_retrieval.__all__) - set(jax_retrieval.__all__) \
        == {"merge_topk"}


def test_metric_logger_writes_the_same_lines(tmp_path):
    import textreact_tpu.utils.logging as jlog
    import textreact_tpu_torch.utils.logging as plog
    assert plog.log.name == "textreact_tpu_torch"
    records = []
    for mod, name in ((jlog, "jax"), (plog, "port")):
        logger = mod.MetricLogger(str(tmp_path / name), use_wandb=False)
        logger.log({"train_loss": np.float32(1.5), "acc": 0.25,
                    "lr": np.asarray(1e-4), "resumed_from": "last.ckpt"}, 3)
        logger.log({"val_acc": 1}, 4)
        logger.close()
        text = (tmp_path / name / "metrics.jsonl").read_text()
        records.append([json.loads(line) for line in text.splitlines()])
    for rows in records:
        assert [r.pop("time") >= 0 for r in rows] == [True, True]
    assert records[0] == records[1]
    assert records[1][0] == {"step": 3, "train_loss": 1.5, "acc": 0.25,
                             "lr": 1e-4, "resumed_from": "last.ckpt"}


# ---- the runtime's host modules: table, corpus, neighbors ----------------


def test_table_reads_what_pandas_reads(tmp_path):
    """`utils/table.read_csv` against `pandas.read_csv(keep_default_na=
    False)`: inferred ints, strings with empty cells, a short line, a blank
    line, the head and one row."""
    import pandas as pd
    from fixtures import make_condition_data
    from textreact_tpu_torch.utils.table import read_csv
    root = make_condition_data(str(tmp_path / "d"))
    odd = tmp_path / "odd.csv"
    odd.write_text('id,a,b,c\n1,x,3,\n2,"y,z"\n3,,5,z\n\n4,q,6,w\n')
    for path in (os.path.join(root, "train.csv"),
                 os.path.join(root, "corpus.csv"), str(odd)):
        df = pd.read_csv(path, keep_default_na=False)
        table = read_csv(path)
        assert len(table) == len(df)
        assert list(table.columns) == list(df.columns)
        for col in df.columns:
            assert table[col] == df[col].tolist(), col
        assert table.row(1) == df.iloc[1].to_dict()
        head = table.head(2)
        assert len(head) == 2 and head["id"] == df["id"].tolist()[:2]


def test_neighbors_module_is_a_copy():
    import inspect

    import textreact_tpu.data.neighbors as a
    import textreact_tpu_torch.data.neighbors as b
    names = [n for n, f in vars(a).items()
             if inspect.isfunction(f) and f.__module__ == a.__name__]
    assert names and names == [n for n, f in vars(b).items()
                               if inspect.isfunction(f)
                               and f.__module__ == b.__name__]
    for n in names:
        assert inspect.getsource(getattr(a, n)) == inspect.getsource(
            getattr(b, n)), n


def test_corpus_io_matches(tmp_path):
    from fixtures import make_condition_data
    import textreact_tpu.data.corpus as a
    import textreact_tpu_torch.data.corpus as b
    root = make_condition_data(str(tmp_path / "d"))
    assert a.CONDITION_COLS == b.CONDITION_COLS
    corpus_file = os.path.join(root, "corpus.csv")
    want = a.read_corpus(corpus_file)
    cache = str(tmp_path / "cache")
    assert b.read_corpus(corpus_file, cache) == want      # writes the cache
    assert os.path.exists(os.path.join(cache, "corpus.pkl"))
    assert b.read_corpus(corpus_file, cache) == want      # reads it
    assert a.read_corpus(corpus_file, cache) == want      # same pickle
    train = os.path.join(root, "train.csv")
    assert b.generate_train_label_corpus(train) \
        == a.generate_train_label_corpus(train)
    nn = os.path.join(root, "train_nn.json")
    assert b.read_neighbors(nn) == a.read_neighbors(nn)


def test_loader_and_profiling_helpers_match():
    import textreact_tpu.data.loader as a
    import textreact_tpu_torch.data.loader as b
    for args in ((0, 0, 0), (42, 3, 17), (7, 100, 99999)):
        assert a.example_rng(*args).random() == b.example_rng(*args).random()
    import textreact_tpu.utils.profiling as pa
    import textreact_tpu_torch.utils.profiling as pb
    ta, tb = pa.StepTimer(warmup=1), pb.StepTimer(warmup=1)
    assert ta.steps_per_sec == tb.steps_per_sec == 0.0
    for t in (ta, tb):
        t.tick(), t.tick()
    assert ta.steps_per_sec > 0 and tb.steps_per_sec > 0


# ---- the template slice's copies: the template engine, tables, infos ------

ESTER_TPL = ("[C:1](=[O:2])-[O;H0;D2;+0:3]>>"
             "[C:1](=[O:2])-[OH;D1;+0:4].[OH;D1;+0:3]")
AMIDE_TPL = ("[C:1](=[O:2])-[N;H1;D2;+0:3]>>"
             "[C:1](=[O:2])-[OH;D1;+0:4].[NH2;D1;+0:3]")
BR_TPL = "[Br;H0;D1;+0:1]-[c:2]>>[Br;H0;D1;+0:1]-[Br;H0;D1;+0:3].[cH:2]"
RING_TPL = "[c:1]-[CH3;D1:2]>>[#6:1].[CH3:2]"
SPLIT_TPL = "[C:1]-[OH;D1;+0:2]>>[C:1].[OH;D1;+0:2]"
ENGINE_TEMPLATES = [ESTER_TPL, AMIDE_TPL, BR_TPL, RING_TPL, SPLIT_TPL,
                    "[#7;a:1]:[c:2]>>[N:1]=[C:2]", "[C;R:1]-[C;!R:2]>>[C:1].[C:2]"]


def test_template_engine_has_the_same_public_names():
    import inspect
    for name in ("chem.smarts", "chem.reaction", "evaluation.edit_rank",
                 "evaluation._own_template_apply",
                 "evaluation.template_decode", "data.templates"):
        a = __import__(f"textreact_tpu.{name}", fromlist=["x"])
        b = __import__(f"textreact_tpu_torch.{name}", fromlist=["x"])
        # the framework's and the readers' module names aside, and the
        # switch to the RDKit engine, which the port does not copy: its
        # template decode has the own engine only
        assert _public(a) - {"pd", "jax", "jnp", "ast", "HAS_RDKIT"} \
            == _public(b) - {"torch", "Table", "read_csv", "ast"}, name
    # smarts and reaction are copies: every function's source is the same
    for name in ("smarts", "reaction"):
        a = __import__(f"textreact_tpu.chem.{name}", fromlist=["x"])
        b = __import__(f"textreact_tpu_torch.chem.{name}", fromlist=["x"])
        for fname, f in vars(a).items():
            if inspect.isfunction(f) and f.__module__ == a.__name__:
                assert inspect.getsource(f) \
                    == inspect.getsource(getattr(b, fname)), fname


def _engine_outcome(kit, smiles, template):
    """find_matches of the template's product side and every
    run_retro_template result (reactant SMILES and the three maps), or the
    name of the exception's class."""
    from importlib import import_module
    smarts = import_module(f"{kit}.chem.smarts")
    reaction = import_module(f"{kit}.chem.reaction")
    chem = import_module(f"{kit}.chem")

    def run():
        mol = chem.parse_smiles(smiles)
        lhs = template.split(">>")[0]
        matches = smarts.find_matches(smarts.parse_smarts(lhs), mol)
        local = ">>".join(f"({part})" for part in template.split(">>"))
        applied = [(reaction.mol_fragments_smiles(a.mol), a.map_to_product,
                    a.map_to_new, a.new_to_product)
                   for a in reaction.run_retro_template(
                       mol, local, check_valence=False)]
        return matches, applied
    return _outcome(run)


@pytest.mark.parametrize("source", ["fixtures", "goldens"])
def test_template_engine_gives_the_same_outputs(source):
    """`find_matches` and `run_retro_template` of both packages on the
    SMILES of the template fixtures and a stride of the canonicalizer's
    goldens, under templates that match, cut rings and fail."""
    if source == "fixtures":
        smiles = ["CCOC(C)=O", "COC(=O)CC", "CCOC(=O)C(C)C", "O=C1CCCO1",
                  "O=C1CCCN1", "Brc1ccc2[nH]ccc2c1", "Cc1ccccc1",
                  "CC(=O)Oc1ccccc1C(=O)O", "OCC[C@H](O)C", "not a smiles"]
    else:
        smiles = _golden_smiles()[::9]
    hits = set()
    for s in smiles:
        for tpl in ENGINE_TEMPLATES:
            ref = _engine_outcome("textreact_tpu", s, tpl)
            got = _engine_outcome("textreact_tpu_torch", s, tpl)
            assert got == ref, (s, tpl)
            if isinstance(got, tuple) and got[1]:
                hits.add(tpl)
    assert len(hits) >= 4, hits


def test_template_tables_and_infos_read_what_pandas_reads(tmp_path):
    """`data/templates.py` and `template_decode.load_template_infos` over
    utils/table.py against the JAX package's over pandas, on the template
    fixtures; the `Class` column comes back as ints, as pandas infers it,
    so the decode's class lookups meet the predicted ints."""
    import pandas as pd
    import textreact_tpu.data.templates as jt
    import textreact_tpu.evaluation.template_decode as jd
    import textreact_tpu_torch.data.templates as pt
    import textreact_tpu_torch.evaluation.template_decode as pd_
    from test_torch_template import (PRODUCTS, _write_template_data,
                                     write_ester_data)
    from textreact_tpu_torch.utils.table import read_csv
    for root in (_write_template_data(str(tmp_path / "tpl"), PRODUCTS),
                 write_ester_data(str(tmp_path / "ester"))):
        a, b = jt.load_template_tables(root), pt.load_template_tables(root)
        assert (b.atom_templates, b.bond_templates) \
            == (a.atom_templates, a.bond_templates)
        for split in ("train", "val", "test"):
            assert pt.load_preprocessed_labels(root, split) \
                == jt.load_preprocessed_labels(root, split)
        for name in ("atom_templates.csv", "bond_templates.csv"):
            df = pd.read_csv(os.path.join(root, name))
            table = read_csv(os.path.join(root, name))
            assert table["Class"] == df["Class"].tolist()
            assert all(type(c) is int for c in table["Class"])
            assert dict(zip(table["Class"], table["Template"])) \
                == dict(zip(df["Class"], df["Template"]))
    assert pd_.load_template_infos(root) == jd.load_template_infos(root)
    assert pt.load_preprocessed_labels(
        str(tmp_path / "tpl"), "train")[2][3] == []    # 'set()'


# ---- the curation slice's copies: preprocess/, templates/, the ionic table -

CURATION_MODULES = [
    "preprocess", "preprocess.aides", "preprocess.augment", "preprocess.cli",
    "preprocess.condition_extraction", "preprocess.condition_splits",
    "preprocess.corpus_tools", "preprocess.frequency_baseline",
    "preprocess.ionic", "preprocess.retro_tools", "templates",
    "templates.smarts_canon", "templates.labeling",
    "templates.native_labeling", "templates.native_extractor",
    "templates.extractor", "templates.processor"]
# names of the JAX modules that the port leaves out: the RDKit engine
# (extractor.py's and labeling.py's RDKit halves, retro_tools' and the
# processor's switch to it) and what only those halves import
CURATION_LEFT_OUT = {
    "preprocess.retro_tools": {"HAS_RDKIT"},
    "templates.labeling": {"HAS_RDKIT", "List", "chs_changes",
                           "label_forward_edit_sites",
                           "label_retro_edit_sites"},
    "templates.extractor": {"HAS_RDKIT", "List", "Tuple",
                            "canonicalize_smarts", "changed_atoms",
                            "deepcopy", "fragments_for_changed_atoms",
                            "match_label", "reassign_atom_maps",
                            "reorder_sides", "split_reagents"},
    "templates.processor": {"HAS_RDKIT"},
}
# pandas on one side, the port's table helpers on the other
TABLE_NAMES = {"Table", "concat", "fillna", "isna", "read_csv",
               "shuffled_positions"}


@pytest.mark.parametrize("name", CURATION_MODULES)
def test_curation_modules_have_the_same_public_names(name):
    """Functions, classes and constants (modules aside: a package holds
    the submodules this process happened to import)."""
    import inspect
    a = __import__(f"textreact_tpu.{name}", fromlist=["x"])
    b = __import__(f"textreact_tpu_torch.{name}", fromlist=["x"])

    def names(m):
        return {n for n in _public(m) if not inspect.ismodule(getattr(m, n))}
    left_out = CURATION_LEFT_OUT.get(name, set())
    assert left_out <= names(a)
    assert names(a) - left_out \
        == names(b) - TABLE_NAMES
    assert getattr(a, "__all__", None) == getattr(b, "__all__", None)


@pytest.mark.parametrize("name", ["preprocess.ionic", "templates.smarts_canon",
                                  "templates.native_labeling",
                                  "templates.native_extractor"])
def test_curation_copies_have_the_same_functions(name):
    """The modules the port copies whole: every function's source is the
    JAX module's."""
    import inspect
    a = __import__(f"textreact_tpu.{name}", fromlist=["x"])
    b = __import__(f"textreact_tpu_torch.{name}", fromlist=["x"])
    names = [n for n, f in vars(a).items()
             if (inspect.isfunction(f) or inspect.isclass(f))
             and f.__module__ == a.__name__]
    assert names
    for n in names:
        assert inspect.getsource(getattr(a, n)) \
            == inspect.getsource(getattr(b, n)), n


def test_ionic_asset_is_the_same_file():
    import textreact_tpu
    import textreact_tpu_torch
    path = os.path.join("assets", "reagent_ionic_compounds.txt")
    a = os.path.join(os.path.dirname(textreact_tpu.__file__), path)
    b = os.path.join(os.path.dirname(textreact_tpu_torch.__file__), path)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
