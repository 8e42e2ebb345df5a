"""The port's offline curation (`textreact_tpu_torch/preprocess/`) against
the JAX package's (`textreact_tpu/preprocess/`), tolerance 0: every case of
tests/test_preprocess.py and tests/test_condition_extraction.py through
both packages (frames compared as column lists, the CML fixture's rows and
patent info as dicts), and both command lines on seeded raw rows, every
file they write equal byte for byte. The port's command lines run in a
process where `import pandas` fails; the JAX package's run here, with it."""

import _torch_threads  # noqa: F401  (before torch runs)
import filecmp
import json
import math
import os
import random

import pandas as pd
import pytest

import chip_smoke
import textreact_tpu.preprocess as jp
import textreact_tpu_torch.preprocess as tp
from test_condition_extraction import CML
from textreact_tpu.preprocess import aides as j_aides
from textreact_tpu.preprocess import cli as j_cli
from textreact_tpu.preprocess import condition_extraction as j_ce
from textreact_tpu.preprocess import ionic as j_ionic
from textreact_tpu_torch.preprocess import aides as t_aides
from textreact_tpu_torch.preprocess import condition_extraction as t_ce
from textreact_tpu_torch.preprocess import ionic as t_ionic
from textreact_tpu_torch.utils.table import Table


def both(columns: dict):
    """The same columns as a DataFrame (JAX) and a Table (port)."""
    return (pd.DataFrame(columns),
            Table({k: list(v) for k, v in columns.items()}))


def cells(frame) -> dict:
    """Column name -> the repr of every cell, for a DataFrame or a Table:
    1, 1.0, '1' and True all differ."""
    if isinstance(frame, pd.DataFrame):
        return {c: [repr(v) for v in frame[c].tolist()] for c in frame.columns}
    return {c: [repr(v) for v in frame[c]] for c in frame.columns}


def same(jax_frame, port_table):
    assert cells(port_table) == cells(jax_frame)


# ---- tests/test_preprocess.py, case by case ----------------------------------

CORPUS = {"id": ["a", "b", "c", "d"], "heading_text": ["", "", "", ""],
          "paragraph_text": ["text one", "text two", "text one", "text three"]}


def test_dedup_corpus_and_corpus_id_column():
    jdf, tdf = both(CORPUS)
    (jd, jm), (td, tm) = jp.dedup_corpus(jdf), tp.dedup_corpus(tdf)
    same(jd, td)
    assert tm == jm
    jx, tx = both({"id": ["c", "x"], "val": [1, 2]})
    same(jp.add_corpus_id_column(jx, jm), tp.add_corpus_id_column(tx, tm))
    same(jp.grant_only_corpus(jdf), tp.grant_only_corpus(tdf))


@pytest.mark.parametrize("frac,seed", [((0.6, 0.2, 0.2), 0),
                                       ((0.8, 0.1, 0.1), 123)])
def test_random_split_no_overlap(frac, seed):
    rxns = [f"rxn{i}" for i in range(50)] + ["dup"] * 10
    jdf, tdf = both({"id": list(range(60)), "canonical_rxn": rxns})
    same(jp.random_split_no_overlap(jdf, frac=frac, seed=seed),
         tp.random_split_no_overlap(tdf, frac=frac, seed=seed))


def test_time_split():
    jdf, tdf = both({"source": ["p1", "p2", "p3", "p4"], "x": list(range(4))})
    years = {"p1": 2010, "p2": 2015, "p3": 2016, "p4": 2012}
    for a, b in zip(jp.time_split(jdf, years), tp.time_split(tdf, years)):
        same(a, b)


def test_condition_vocab():
    jdf, tdf = both({"catalyst1": ["", "Pd"], "solvent1": ["CCO", ""],
                     "solvent2": ["", ""], "reagent1": ["O", "O"],
                     "reagent2": ["", 3]})
    assert tp.condition_vocab(tdf) == jp.condition_vocab(jdf)


@pytest.mark.parametrize("rxn", ["[CH3:1][OH:2].CC(O)=O>>CC(=O)OC",
                                 "CCO.CC(=O)O>CO>CC(=O)OCC",
                                 "not a smiles>>CC"])
def test_canonical_rxn_smiles(rxn):
    assert tp.canonical_rxn_smiles(rxn) == jp.canonical_rxn_smiles(rxn)


@pytest.mark.parametrize("a,b", [("CCO.CC(=O)O>>CC(=O)OCC",
                                  "CCO.CC(=O)O>>CC(=O)OCC"),
                                 ("CCO.CC(=O)O>>CC(=O)OCC", "CCN>>CCN"),
                                 ("CC(=O)Cl.OC>>CC(=O)OC",
                                  "CC(=O)Cl.OCC>>CC(=O)OCC")])
def test_reaction_similarity(a, b):
    assert tp.reaction_similarity(a, b) == jp.reaction_similarity(a, b)


def test_match_to_corpus_exact_similar_and_unk():
    corpus = {"id": ["US1_0", "US2_0", "US2_1"],
              "source": ["US1", "US2", "US2"],
              "canonical_rxn": ["CCO>>CCN", "CC>>CO", "CCC(=O)Cl.OC>>CCC(=O)OC"]}
    split = {"id": ["US1", "US9", "US2"],
             "reactant_smiles": ["CCO", "OCO", "CCC(=O)Cl.OCC"],
             "product_smiles": ["CCN", "OCN", "CCC(=O)OCC"]}
    (jc, tc), (js, ts) = both(corpus), both(split)
    for threshold in (0.9, 0.1):
        same(jp.match_to_corpus(js, jc, "test", threshold),
             tp.match_to_corpus(ts, tc, "test", threshold))


def test_year_resplit():
    parts = [{"id": ["P1_0", "P2_0", "P3_0"], "x": [1, 2, 3]},
             {"id": ["P4_0"], "y": ["z"]}]
    years = {"P1": 2010, "P2": 2012, "P3": 2015}
    ref = jp.year_resplit([pd.DataFrame(p) for p in parts], years)
    got = tp.year_resplit([both(p)[1] for p in parts], years)
    for a, b in zip(ref, got):
        same(a, b)


def test_augment_condition_train():
    cols = {"canonical_rxn": ["CCO.CC>>CCOC", "CC(=O)Cl.OC>>CC(=O)OC"],
            "catalyst1": ["Pd", ""], "year": [2001, 2002]}
    jdf, tdf = both(cols)
    for n, seed in ((3, 1), (5, 0)):
        same(jp.augment_condition_train(jdf, n=n, seed=seed),
             tp.augment_condition_train(tdf, n=n, seed=seed))


def test_frequency_baseline():
    cols = {"catalyst1": ["", "", "Pd"], "solvent1": ["CCO", "CCO", ""],
            "solvent2": ["", "", ""], "reagent1": ["", "", ""],
            "reagent2": ["", "", ""]}
    jdf, tdf = both(cols)
    assert tp.top_condition_tuples(tdf, 2) == jp.top_condition_tuples(jdf, 2)
    jt, tt = jdf.iloc[:2].reset_index(drop=True), tdf.head(2)
    assert tp.dummy_predictions(tt, [["x"] * 5]) \
        == jp.dummy_predictions(jt, [["x"] * 5])
    assert tp.frequency_baseline_accuracy(tdf, tt, k=15) \
        == jp.frequency_baseline_accuracy(jdf, jt, k=15)


def _cli_fixture(root):
    """tests/test_preprocess.py's command-line inputs."""
    rows = [{"id": f"P{i % 10}_{i}", "source": f"P{i % 10}",
             "canonical_rxn": f"r{i}>>p{i}", "remapped_rxn": f"m{i}",
             "catalyst": "Pd", "solvent": "CCO.ClCCl", "reagent": "O"}
            for i in range(150)]
    pd.DataFrame(rows).to_csv(root / "conditions.csv", index=False)
    (root / "patent_info.json").write_text(json.dumps(
        {f"P{i}": {"year": 2010 + i} for i in range(10)}))
    pd.DataFrame({"id": ["a", "b", "c"], "heading_text": ["", "", ""],
                  "paragraph_text": ["x", "x", "y"]}).to_csv(
        root / "corpus.csv", index=False)


def _seeded_fixture(digit_sources):
    def write(root):
        chip_smoke.write_raw_conditions(root, rows=300, paragraphs=360,
                                        words=12, seed=3,
                                        digit_sources=digit_sources)
    return write


def _run_both_clis(tmp_path, write, threshold):
    raw = tmp_path / "raw"
    raw.mkdir()
    write(raw)
    argv = {"condition-split": ["--input", raw / "conditions.csv",
                                "--patent_info", raw / "patent_info.json",
                                "--remove_threshold", threshold],
            "dedup-corpus": ["--input", raw / "corpus.csv"]}
    for command, args in argv.items():
        j_cli.main([command, *map(str, args),
                    "--output_path", str(tmp_path / "jax")])
        chip_smoke.run_without_pandas(
            "textreact_tpu_torch.preprocess.cli.main",
            [command, *args, "--output_path", tmp_path / "port"])
    return tmp_path / "jax", tmp_path / "port"


def _same_files(a, b):
    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name
    return names


@pytest.mark.parametrize("fixture,threshold", [
    ("test_preprocess", 10), ("seeded", 10), ("seeded_digit_sources", 10),
    ("seeded", 30)])
def test_clis_write_the_same_files_without_pandas(tmp_path, fixture,
                                                  threshold):
    """Both commands, --patent_info included: every file byte for byte.
    Patents named by digits alone read as ints in both packages, so the
    time split finds none of their years (all rows train); at a threshold
    of 30 most of the 300 rows are filtered out."""
    write = _cli_fixture if fixture == "test_preprocess" else \
        _seeded_fixture(fixture.endswith("digit_sources"))
    jax_dir, port_dir = _run_both_clis(tmp_path, write, threshold)
    names = _same_files(jax_dir, port_dir)
    assert len(names) == 13, names
    split = pd.read_csv(port_dir / "USPTO_condition.csv",
                        keep_default_na=False)
    if fixture.startswith("seeded"):
        assert split["confidence"].dtype == "float64"
        assert set(split["dataset"]) == {"train", "val", "test"}
    years = pd.read_csv(port_dir / "year_split" / "USPTO_condition_train.csv",
                        keep_default_na=False)
    if fixture == "seeded_digit_sources":
        assert len(years) == len(split)


# ---- tests/test_condition_extraction.py, case by case -----------------------


def test_parse_cml(tmp_path):
    path = tmp_path / "2005" / "rxn.xml"
    path.parent.mkdir()
    path.write_text(CML)
    assert t_ce.parse_cml_reactions(str(path)) \
        == j_ce.parse_cml_reactions(str(path))
    for kw in ({"year": 2011, "patent_type": "application"}, {}):
        other = tmp_path / "misc" / "rxn.xml"
        other.parent.mkdir(exist_ok=True)
        other.write_text(CML)
        assert t_ce.parse_cml_reactions(str(other), **kw) \
            == j_ce.parse_cml_reactions(str(other), **kw)


def _merge_filter_slots(rows, chunks=1, threshold=100):
    size = -(-len(rows) // chunks)
    parts = [rows[i:i + size] for i in range(0, len(rows), size)]
    jdb, jf = j_ce.merge_and_dedup([pd.DataFrame(p) for p in parts])
    tdb, tf = t_ce.merge_and_dedup(
        [Table({k: [r[k] for r in p] for k in p[0]}) for p in parts])
    same(jdb, tdb)
    assert jf.keys() == tf.keys()
    for role in jf:
        same(jf[role], tf[role])
    jout = j_ce.filter_and_split_conditions(jdb, jf, remove_threshold=threshold)
    tout = t_ce.filter_and_split_conditions(tdb, tf, remove_threshold=threshold)
    same(jout, tout)
    same(j_ce.split_condition_slots(jout), t_ce.split_condition_slots(tout))


@pytest.mark.parametrize("chunks", [1, 3])
def test_merge_dedup_and_filter(chunks):
    rows = []
    for i in range(120):
        rows.append({"canonical_rxn": f"r{i}", "remapped_rxn": f"m{i}",
                     "catalyst": "Pd", "solvent": "CCO", "reagent": "O"})
    rows.append(dict(rows[0]))  # exact duplicate
    rows.append({"canonical_rxn": "special", "remapped_rxn": "ms",
                 "catalyst": "RareCat", "solvent": "CCO", "reagent": "O"})
    rows.append({"canonical_rxn": "excess", "remapped_rxn": "me",
                 "catalyst": "Pd.Pt", "solvent": "CCO", "reagent": "O"})
    _merge_filter_slots(rows, chunks)


def test_filter_ionic_reagents_stage3():
    rows = []
    for i in range(120):
        rows.append({"canonical_rxn": f"r{i}", "remapped_rxn": f"m{i}",
                     "catalyst": "", "solvent": "CCO",
                     "reagent": "O.[Na+].[OH-]"})
    for i in range(120):
        rows.append({"canonical_rxn": f"s{i}", "remapped_rxn": f"n{i}",
                     "catalyst": "", "solvent": "CCO", "reagent": "[Na+]"})
    for i in range(120):
        rows.append({"canonical_rxn": f"t{i}", "remapped_rxn": f"o{i}",
                     "catalyst": "", "solvent": "CCO",
                     "reagent": "O.CCO.CCN"})
    _merge_filter_slots(rows)


def test_chunks_with_missing_columns_and_nan_cells():
    """Chunks that lack a column (NaN over their rows: ints become floats)
    and NaN condition cells, filtered at a low threshold."""
    rows = [{"canonical_rxn": f"r{i % 7}", "catalyst": "Pd" if i % 3 else "",
             "solvent": "CCO.ClCCl" if i % 2 else math.nan,
             "reagent": ["O", "[Na+].[OH-]", "CCN(CC)CC.O", math.nan][i % 4],
             "year": 2000 + i} for i in range(40)]
    for r in rows[20:]:
        del r["year"]
    parts = [rows[:20], rows[20:]]
    jdb, jf = j_ce.merge_and_dedup([pd.DataFrame(p) for p in parts])
    tdb, tf = t_ce.merge_and_dedup(
        [Table({k: [r[k] for r in p] for k in p[0]}) for p in parts])
    same(jdb, tdb)
    for role in jf:
        same(jf[role], tf[role])
    same(j_ce.filter_and_split_conditions(jdb, jf, remove_threshold=3),
         t_ce.filter_and_split_conditions(tdb, tf, remove_threshold=3))


def _outcome(fn, *args):
    """The value, or the name of the exception's class."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__


@pytest.mark.parametrize("smiles", ["CCO", "[Na+]", "[O-]S(=O)(=O)[O-]",
                                    "C[N+](C)(C)CC([O-])=O", "[Mg+2].[Cl-]",
                                    "not smiles("])
def test_mol_charge_classes(smiles):
    assert _outcome(t_ionic.mol_charge, smiles) \
        == _outcome(j_ionic.mol_charge, smiles)


@pytest.mark.parametrize("reagent", [
    "O.[Al+3].[H-].[H-].[H-].[H-].[Li+].[Na+].[OH-]", "[Na+]", "CCO.[Na+]",
    "[Na+].[OH-].[Na+].[OH-].CCO", float("nan"), None, "", "CCO.someName",
    "O=C([O-])[O-].[K+].[K+]", "O.[Li+].[OH-]"])
def test_ionic_strip_and_split(reagent):
    jt, tt = j_ionic.IonicCompoundTable.load(), t_ionic.IonicCompoundTable.load()
    assert tt.entries == jt.entries
    assert t_ionic.split_reagent_combination(reagent, tt) \
        == j_ionic.split_reagent_combination(reagent, jt)


def test_split_token_two_solvents():
    jdf, tdf = both({"catalyst_split": ["", "Pd"],
                     "solvent_split": [f"CCO{j_ce.SPLIT_TOKEN}ClCCl", ""],
                     "reagent_split": ["O", f"A{j_ce.SPLIT_TOKEN}B"]})
    assert t_ce.SPLIT_TOKEN == j_ce.SPLIT_TOKEN
    same(j_ce.split_condition_slots(jdf), t_ce.split_condition_slots(tdf))


def test_assign_conditions_and_names():
    roles = {"c1": ["Pd", "[Na+].[OH-]"], "s1": ["CCO", "ClCCl"], "r1": ["O"]}
    present = {"Pd", "CCO", "O", "[Na+]"}
    assert t_aides.assign_conditions(present, roles) \
        == j_aides.assign_conditions(present, roles)
    vals = ["CCO", "tetrahydrofuran", "CCO", "tetrahydrofuran", "not smiles(",
            "", "sodium methoxide", "sodium methoxide", "sodium methoxide"]
    assert t_aides.extract_non_smiles(vals) == j_aides.extract_non_smiles(vals)
    jdf, tdf = both({"catalyst1": ["tetrahydrofuran"], "solvent1": ["CCO"],
                     "solvent2": [""], "reagent1": [""], "reagent2": [""],
                     "other": ["tetrahydrofuran"]})
    names = {"tetrahydrofuran": "C1CCOC1"}
    same(j_aides.merge_name_to_smiles(jdf, names),
         t_aides.merge_name_to_smiles(tdf, names))


def test_gated_stages_raise_as_in_the_jax_package():
    """RXNMapper and RDKit are in neither environment: the same error."""
    for mod in (j_ce, t_ce):
        with pytest.raises(NotImplementedError, match="RXNMapper"):
            mod.remap_reaction("CC>>CO", "", "", "")
    for mod in (j_aides, t_aides):
        with pytest.raises(NotImplementedError, match="RDKit"):
            mod.brics_fragments(["CCO"])


def test_random_split_keeps_labels_apart_from_positions():
    """The split assigns by the rows' labels in the unshuffled frame while
    the rows come out shuffled: a frame whose canonical_rxn repeats in a
    pattern that a mix-up of labels and positions would break."""
    rng = random.Random(5)
    rxns = [f"r{rng.randrange(40)}" for _ in range(200)]
    jdf, tdf = both({"n": list(range(200)), "canonical_rxn": rxns})
    out = tp.random_split_no_overlap(tdf, seed=9)
    same(jp.random_split_no_overlap(jdf, seed=9), out)
    by = {}
    for rxn, ds in zip(out["canonical_rxn"], out["dataset"]):
        by.setdefault(rxn, set()).add(ds)
    assert all(len(v) == 1 for v in by.values())


def test_a_filter_that_keeps_no_row(tmp_path):
    """Where the frequency filter keeps no row, the JAX package's
    `db[keep]` takes an empty list of flags for an empty list of columns
    and fails on the next column it reads; the port's table keeps its
    columns and writes files of a header alone. A recorded difference: the
    JAX package has no output to match."""
    raw = tmp_path / "raw"
    raw.mkdir()
    _seeded_fixture(False)(raw)
    argv = ["condition-split", "--input", str(raw / "conditions.csv"),
            "--remove_threshold", "1000"]
    with pytest.raises(KeyError):
        j_cli.main(argv + ["--output_path", str(tmp_path / "jax")])
    chip_smoke.run_without_pandas("textreact_tpu_torch.preprocess.cli.main",
                                  argv + ["--output_path", tmp_path / "port"])
    header = (tmp_path / "port" / "train.csv").read_text().splitlines()
    assert len(header) == 1 and header[0].endswith(",dataset")
