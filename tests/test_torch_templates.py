"""The port's template preprocessing (`textreact_tpu_torch/templates/`)
against the JAX package's native engine (`textreact_tpu/templates/`),
tolerance 0: extraction results on every mapped reaction of the extraction
tests, the SMARTS canonicalizer on tests/test_templates.py's cases, the
processor's files byte for byte on the fixtures of the processor and full
cycle tests, the command line in a process where `import pandas` fails,
the engine gates, and the full cycle on the port alone: its processor's
labels train its template trainer on the CPU and decode back to the
reactants."""

import _torch_threads  # noqa: F401  (before torch runs)
import ast
import filecmp
import inspect
import json
import os
from pathlib import Path

import pytest

import chip_smoke
import test_processor_native as fixture_native
import test_template_full_cycle as fixture_cycle
from textreact_tpu.templates import extractor as j_extractor
from textreact_tpu.templates import native_labeling as j_labeling
from textreact_tpu.templates import processor as j_processor
from textreact_tpu.templates import smarts_canon as j_canon
from textreact_tpu_torch.templates import extractor as t_extractor
from textreact_tpu_torch.templates import labeling as t_dispatch
from textreact_tpu_torch.templates import native_labeling as t_labeling
from textreact_tpu_torch.templates import processor as t_processor
from textreact_tpu_torch.templates import smarts_canon as t_canon

TESTS = Path(__file__).resolve().parent


def _literal_reactions():
    """Every mapped reaction written out as a literal in the native
    extraction tests (implicit concatenations joined, f-strings left out)."""
    from textreact_tpu_torch.chem import parse_smiles
    found = []
    for name in ("test_native_extraction.py", "test_extraction_fuzz_r5.py"):
        tree = ast.parse((TESTS / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and ">>" in node.value and ":" in node.value:
                try:
                    for side in node.value.split(">>"):
                        parse_smiles(side)
                except ValueError:
                    continue
                found.append(node.value)
    return list(dict.fromkeys(found))


REACTIONS = _literal_reactions()
FIXTURE_REACTIONS = list(dict.fromkeys(
    REACTIONS + fixture_native.TRAIN + fixture_native.VAL
    + fixture_native.TEST + fixture_cycle.RXNS))
SETTINGS = [None, {"use_stereo": False}, {"use_symbol": False},
            {"remote": False}]


def test_the_fixtures_hold_enough_reactions():
    assert len(REACTIONS) >= 25 and len(FIXTURE_REACTIONS) >= 40


@pytest.mark.parametrize("settings", SETTINGS, ids=["default", "no_stereo",
                                                    "no_symbol", "no_remote"])
def test_extraction_gives_the_same_results(settings):
    for i, rxn in enumerate(FIXTURE_REACTIONS):
        arg = {"reactants": rxn.split(">>")[0],
               "products": rxn.split(">>")[1], "_id": i}
        assert t_extractor.extract_template(arg, settings) \
            == j_extractor.extract_template(arg, settings, engine="native"), rxn


def test_forward_labeling_gives_the_same_edits():
    for rxn in FIXTURE_REACTIONS:
        result = j_extractor.extract_template(rxn, engine="native")
        if "reaction_smarts" not in result:
            continue
        args = (result["reactants"], result["products"],
                result["replacement_dict"], result["change_atoms"])
        for retro in (True, False):
            for remote in (True, False):
                kw = dict(retro=retro, remote=remote)
                assert t_labeling.match_label(*args, **kw) \
                    == j_labeling.match_label(*args, **kw), rxn
                assert t_dispatch.match_label(*args, engine="native", **kw) \
                    == j_labeling.match_label(*args, **kw)


def test_canonical_products_and_bonds_are_the_same():
    smiles = chip_smoke.DRUGS + [r.split(">>")[1] for r in FIXTURE_REACTIONS]
    for s in smiles:
        assert t_processor.canonical_product(s) \
            == j_processor.canonical_product(s, engine="native")
        ours = t_dispatch.bonds_from_smiles(s)
        theirs = j_labeling.bonds_from_smiles(s)
        # the same set, built in the same order: its repr is a file's bytes
        assert ours == theirs and repr(ours) == repr(theirs)


def test_smarts_canon_is_a_copy_and_gives_the_same_strings():
    for name, f in vars(j_canon).items():
        if inspect.isfunction(f) and f.__module__ == j_canon.__name__:
            assert inspect.getsource(f) == inspect.getsource(
                getattr(t_canon, name)), name
    transform = "([C:7]-[O:9])>>([C:7].[O:9])"
    cases = [("count_atoms", "[CH3:1]-[NH:2]-[CH2]"),
             ("template_score", "[C:1]#[N:2]", {}),
             ("invert_chain", "[O:2]-[C:1]"),
             ("invert_chain", "[C:2]1-[O:1]1"),
             ("invert_template", "[C:1]=[C:2]-[C:3]"),
             ("fragment_permutations", "[C:1]-[C:2]"),
             ("fragment_permutations", "[C:1]-[C:2]=[C:3]"),
             ("enumerate_label_orders", "[C:1]-[C:2]>>[C:1]-[C:2]"),
             ("reorder_sides", "([O:2]).([C:1])"),
             ("sort_fragments", "([O:2].[C:1]=[O:3])>>([C:1])", {}),
             ("reassign_atom_maps", transform, {})]
    for name, *args in cases:
        assert getattr(t_canon, name)(*args) == getattr(j_canon, name)(*args)
    for h, c, s in (({1: 0}, {1: 0}, {}), ({1: 1}, {1: -1}, {1: 2})):
        assert t_processor.full_template("[C:1]>>[C:1]", h, c, s) \
            == j_processor.full_template("[C:1]>>[C:1]", h, c, s)


def _write_splits(root, splits):
    root.mkdir(parents=True, exist_ok=True)
    for name, rxns in splits.items():
        rows = "".join(f"{i},{r}\n" for i, r in enumerate(rxns))
        (root / f"{name}.csv").write_text("id,rxn_smiles\n" + rows)


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name
    return names


FILES = ["atom_templates.csv", "bond_templates.csv", "labeled_data.csv",
         "preprocessed_test.csv", "preprocessed_train.csv",
         "preprocessed_val.csv", "simulate_output.txt", "template_infos.csv"]


@pytest.mark.parametrize("fixture,settings", [
    ("processor_native", None), ("full_cycle", None),
    ("extraction_tests", None), ("processor_native", {"max_edit_n": 0}),
    ("extraction_tests", {"use_stereo": False}), ("empty_val", None)])
def test_processor_writes_the_same_files(tmp_path, fixture, settings):
    splits = {
        "processor_native": {"train": fixture_native.TRAIN,
                             "val": fixture_native.VAL,
                             "test": fixture_native.TEST},
        "full_cycle": {"train": fixture_cycle.RXNS * 24,
                       "val": fixture_cycle.RXNS, "test": fixture_cycle.RXNS},
        "extraction_tests": {"train": REACTIONS, "val": REACTIONS[:7],
                             "test": REACTIONS[-9:]},
        "empty_val": {"train": fixture_native.TRAIN, "val": [],
                      "test": fixture_native.TEST},
    }[fixture]
    _write_splits(tmp_path / "in", splits)
    files = [str(tmp_path / "in" / f"{s}.csv") for s in ("train", "val",
                                                          "test")]
    j_processor.TemplateProcessor(*files, str(tmp_path / "jax"),
                                  settings=settings, engine="native").run()
    proc = t_processor.TemplateProcessor(*files, str(tmp_path / "port"),
                                         settings=settings)
    assert proc.engine == "native"
    proc.run()
    assert _same_dirs(tmp_path / "jax", tmp_path / "port") == FILES


def test_command_line_writes_the_same_files_without_pandas(tmp_path):
    chip_smoke.write_mapped_reactions(
        tmp_path / "in", {"train": 96, "val": 16, "test": 16}, seed=1)
    argv = ["--train_file", tmp_path / "in" / "train.csv",
            "--valid_file", tmp_path / "in" / "val.csv",
            "--test_file", tmp_path / "in" / "test.csv"]
    j_processor.main([*map(str, argv), "--engine", "native",
                      "--output_path", str(tmp_path / "jax")])
    chip_smoke.run_without_pandas(
        "textreact_tpu_torch.templates.processor.main",
        argv + ["--output_path", tmp_path / "port"])
    assert _same_dirs(tmp_path / "jax", tmp_path / "port") == FILES
    artifacts = chip_smoke.check_template_artifacts(tmp_path / "port",
                                                    tmp_path / "in")
    assert artifacts["coverage"]["train"] == 1.0
    assert artifacts["gold_decode"] == 1.0


def test_the_rdkit_engine_is_gated_as_in_the_jax_package(tmp_path):
    """No environment of the port has RDKit: 'rdkit' raises
    NotImplementedError with the JAX processor's message (the JAX package
    raises it wherever RDKit is absent, as here), 'auto' is the native
    engine."""
    from textreact_tpu.chem.rdkit_bridge import HAS_RDKIT
    assert not HAS_RDKIT
    files = [str(tmp_path / f"{s}.csv") for s in ("train", "val", "test")]
    with pytest.raises(NotImplementedError) as jax_error:
        j_processor.TemplateProcessor(*files, str(tmp_path / "j"),
                                      engine="rdkit")
    with pytest.raises(NotImplementedError) as port_error:
        t_processor.TemplateProcessor(*files, str(tmp_path / "p"),
                                      engine="rdkit")
    assert str(port_error.value) == str(jax_error.value)
    rxn = fixture_native.TRAIN[0]
    for call in (lambda: t_extractor.extract_template(rxn, engine="rdkit"),
                 lambda: t_dispatch.bonds_from_smiles("CCO", engine="rdkit"),
                 lambda: t_dispatch.match_label("C", "C", {}, []),
                 lambda: t_processor.canonical_product("CCO", "rdkit")):
        with pytest.raises(NotImplementedError):
            call()
    assert t_extractor.extract_template(rxn, engine="auto") \
        == j_extractor.extract_template(rxn, engine="native")
    with pytest.raises(NotImplementedError):
        j_extractor.extract_template(rxn, engine="rdkit")


def test_full_cycle_on_the_port(tmp_path):
    """tests/test_template_full_cycle.py's cycle on the port alone: mapped
    reactions -> the port's processor (its files equal the JAX processor's)
    -> the port's template trainer on the CPU -> ranked edits -> the own
    template decode -> the retro metric."""
    from textreact_tpu_torch.chem import parse_smiles
    from textreact_tpu_torch.config import ExperimentConfig
    from textreact_tpu_torch.evaluation.retro import evaluate_retrosynthesis
    from textreact_tpu_torch.templates.native_extractor import \
        demapped_canonical
    from textreact_tpu_torch.train.trainer import Trainer
    from textreact_tpu_torch.utils.table import Table, read_csv
    rxns = fixture_cycle.RXNS
    root = tmp_path / "data"
    _write_splits(root / "raw", {"train": rxns * 24, "val": rxns,
                                 "test": rxns})
    files = [str(root / "raw" / f"{s}.csv") for s in ("train", "val", "test")]
    t_processor.TemplateProcessor(*files, str(root)).run()
    j_processor.TemplateProcessor(*files, str(tmp_path / "jax"),
                                  engine="native").run()
    for name in FILES:
        assert filecmp.cmp(root / name, tmp_path / "jax" / name,
                           shallow=False), name
    for split in ("train", "val", "test"):
        pre = read_csv(str(root / f"preprocessed_{split}.csv"))
        assert all(ast.literal_eval(v) for v in pre["Labels"]), split
        Table({"id": [f"{split}{i}" for i in range(len(pre))],
               "product_smiles": pre["ProductCanonSmiles"],
               "reactant_smiles": [demapped_canonical(parse_smiles(r))
                                   for r in pre["Reactants"]]}
              ).to_csv(str(root / f"{split}.csv"))
    (root / "enc.json").write_text(json.dumps(fixture_cycle.TINY_ENC))
    cfg = ExperimentConfig(
        task="retro", template_based=True, unattend_nonbonds=True,
        do_train=True, do_test=True, data_path=str(root),
        template_path=str(root), train_file="train.csv",
        valid_file="val.csv", test_file="test.csv",
        encoder=str(root / "enc.json"), encoder_tokenizer="smiles",
        vocab_file=None, num_neighbors=-1, max_length=64, batch_size=16,
        test_batch_size=8, epochs=8, lr=2e-3, eval_per_epoch=1,
        save_path=str(root / "out"), compute_dtype="float32", log_every=1,
        length_buckets=(64,), debug=True)
    trainer = Trainer(cfg, device="cpu")
    trainer.prepare_data()
    trainer.fit()
    with open(os.path.join(cfg.save_path, "metrics.jsonl")) as f:
        losses = [r["train_loss"] for r in map(json.loads, f)
                  if "train_loss" in r]
    assert losses[-1] < losses[0]
    trainer._load_for_eval()
    loader = trainer._loaders(trainer.test_dataset, eval_mode=True)[0]
    preds = trainer._predict(loader)
    acc = evaluate_retrosynthesis(preds, read_csv(str(root / "test.csv")),
                                  top_k=10, template_based=True,
                                  template_path=str(root))
    assert set(acc) == {1, 2, 3, 5, 10, 20}
    assert acc[3] >= 0.5, acc
    assert acc[10] >= acc[3] >= acc[1] >= 0.0
