"""The port's parity_run.py and check_artifacts.py (scripts/torch_port/)
against the JAX package's (scripts/), on the CPU: the recipes and the
options are the JAX package's but for the port's assets, its bert_l6
preset and `--device`; the smokes of tests/test_parity_run.py run the
port's parity_run.py with `--device cpu` at the same tiny widths
(RetroSyn_tf and RetroSyn_tb are `slow`, as the JAX ones are); the two
checkers print the same report on the same fixture tree but for the
commands they name."""

import _torch_threads  # noqa: F401  (before torch runs)
import ast
import importlib.util
import json
import os
import re

import pytest

from fixtures import make_condition_data, make_retro_data, write_text_vocab
from test_parity_run import RETRO_KS, TINY_DEC, TINY_ENC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PARITY_RUN = os.path.join(REPO, "scripts", "parity_run.py")
PORT_PARITY_RUN = os.path.join(REPO, "scripts", "torch_port", "parity_run.py")
JAX_CHECKER = os.path.join(REPO, "scripts", "check_artifacts.py")
PORT_CHECKER = os.path.join(REPO, "scripts", "torch_port",
                            "check_artifacts.py")
# the port's file for each of the JAX package's that a recipe names
ASSETS = ("textreact_tpu/assets/", "textreact_tpu_torch/assets/")
# the names the two checkers' follow-up lines give
COMMANDS = [("python scripts/parity_run.py",
             "python scripts/torch_port/parity_run.py"),
            ("python -m textreact_tpu.retrieval.convert",
             "python -m textreact_tpu_torch.retrieval.convert")]


def _load(path, name):
    """The script at `path` as a module of its own (not in sys.modules)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _substituted(value):
    if isinstance(value, str):
        return value.replace(*ASSETS)
    if isinstance(value, list):
        return [_substituted(v) for v in value]
    return {k: _substituted(v) for k, v in value.items()}


def _top_level_imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    return names


def test_recipes_equal_the_jax_parity_runs_after_the_substitutions():
    """RECIPES equal, but for the asset paths; the JAX parity_run.py, loaded
    by path under its own name, imports no JAX at module level (its imports
    sit inside main()); the decoder json it names is the port's bert_l6
    preset, field for field."""
    for path in (JAX_PARITY_RUN, PORT_PARITY_RUN):
        top = _top_level_imports(path)
        assert not any(n.split(".")[0] in ("jax", "textreact_tpu",
                                           "textreact_tpu_torch", "torch")
                       for n in top), (path, top)
    jax_parity_run = _load(JAX_PARITY_RUN, "parity_run")
    port_parity_run = _load(PORT_PARITY_RUN, "torch_port_parity_run")
    assert port_parity_run.RECIPES == _substituted(jax_parity_run.RECIPES)
    assert port_parity_run.RECIPES != jax_parity_run.RECIPES
    for recipe in port_parity_run.RECIPES.values():
        for arg in recipe["args"]:
            if arg.startswith("textreact_tpu_torch/"):
                assert os.path.isfile(os.path.join(REPO, arg)), arg
    jax_src = open(JAX_PARITY_RUN).read()
    port_src = open(PORT_PARITY_RUN).read()
    json_path = "textreact_tpu/models/configs/bert_l6.json"
    assert f'"--decoder", "{json_path}"' in jax_src
    assert '"--decoder", "bert_l6"' in port_src
    from textreact_tpu_torch.models.config import (TransformerConfig,
                                                   resolve_config)
    # build_model sets is_decoder and add_cross_attention on any decoder
    # config (models/factory.py), the two fields where the preset differs
    preset = resolve_config("bert_l6")
    assert preset.is_decoder and preset.add_cross_attention
    assert preset.replace(is_decoder=False, add_cross_attention=False) \
        == TransformerConfig.from_json(os.path.join(REPO, json_path))


def _options(main, capsys):
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    return set(re.findall(r"(--[a-z_]+)", capsys.readouterr().out))


def test_parser_holds_every_jax_option_plus_device(capsys):
    jax_options = _options(_load(JAX_PARITY_RUN, "parity_run").main, capsys)
    port = _load(PORT_PARITY_RUN, "torch_port_parity_run")
    port_options = _options(port.main, capsys)
    assert "--recipe" in jax_options and "--override" in jax_options
    assert port_options == jax_options | {"--device"}
    args = port.build_parser().parse_args(
        ["--recipe", "RCR", "--data_path", "d", "--save_path", "s"])
    assert args.device is None   # the card


def _smoke(tmp_path, recipe, root, override, extra=()):
    """The port's parity_run.py on the CPU; returns parity_results.json."""
    parity_run = _load(PORT_PARITY_RUN, "torch_port_parity_run")
    save = str(tmp_path / "out")
    rc = parity_run.main(["--recipe", recipe, "--data_path", root,
                      "--corpus_file", os.path.join(root, "corpus.csv"),
                      "--save_path", save, "--override", " ".join(override),
                      "--device", "cpu", *extra])
    assert rc == 0
    # the neighbor files were built by the fingerprint retriever leg
    for split in ("train", "val", "test"):
        assert os.path.exists(os.path.join(save, "nn", f"{split}.json"))
    with open(os.path.join(save, "parity_results.json")) as f:
        results = json.load(f)
    assert set(results) == {"recipe", "argv", "accuracy"}
    assert results["recipe"] == recipe
    assert results["argv"][-2:] == ["--device", "cpu"]
    return results


def _tiny(root, encoder_tokenizer, decoder=True):
    """tests/test_parity_run.py's overrides, without its --dp_size 2 (a
    mesh needs torchrun's processes in the port)."""
    override = ["--encoder", os.path.join(root, "enc.json")]
    if decoder:
        override += ["--decoder", os.path.join(root, "dec.json")]
    return override + [
        "--encoder_tokenizer", encoder_tokenizer,
        "--text_vocab_file", os.path.join(root, "text_vocab.txt"),
        "--max_length", "64", "--max_dec_length", "16",
        "--batch_size", "8", "--test_batch_size", "8",
        "--epochs", "1", "--num_beams", "3", "--num_neighbors", "2",
        "--compute_dtype", "float32", "--log_every", "1", "--debug"]


def _write_configs(root, enc, dec=None):
    for name, cfg in (("enc.json", enc), ("dec.json", dec)):
        if cfg is not None:
            with open(os.path.join(root, name), "w") as f:
                json.dump(cfg, f)


def test_parity_run_rcr_smoke(tmp_path):
    root = make_condition_data(str(tmp_path / "data"))
    _write_configs(root, TINY_ENC, TINY_DEC)
    results = _smoke(tmp_path, "RCR", root, _tiny(root, "text"))
    accs = results["accuracy"]
    # dual-corpus reporting: full + gold-removed (reference README.md:68-71)
    assert isinstance(accs, list) and len(accs) == 2
    for acc in accs:
        assert set(int(k) for k in acc) == {1, 3, 5, 10, 15}
        assert all(0.0 <= v <= 1.0 for v in acc.values())


@pytest.mark.slow
def test_parity_run_retrosyn_tf_smoke(tmp_path):
    root = make_retro_data(str(tmp_path / "data"))
    _write_configs(root, dict(TINY_ENC, vocab_size=700),
                   dict(TINY_DEC, vocab_size=600))
    results = _smoke(tmp_path, "RetroSyn_tf", root,
                     _tiny(root, "smiles_text"),
                     ["--valid_file", "valid.csv"])
    accs = results["accuracy"]
    assert isinstance(accs, list) and len(accs) == 2
    for acc in accs:
        assert set(int(k) for k in acc) == RETRO_KS
        assert all(0.0 <= v <= 1.0 for v in acc.values())


@pytest.mark.slow
def test_parity_run_retrosyn_tb_smoke(tmp_path):
    """parity_run.py extracts and labels the templates itself (the port's
    native engine) from the mapped CSVs of tests/test_parity_run.py's
    template-based smoke, written without pandas."""
    from textreact_tpu_torch.chem import parse_smiles
    from textreact_tpu_torch.templates.native_extractor import \
        demapped_canonical
    from textreact_tpu_torch.templates.processor import canonical_product
    from textreact_tpu_torch.utils.table import Table

    rxns = [
        "[CH3:1][C:2](=[O:3])[OH:4].[CH3:5][OH:6]>>"
        "[CH3:1][C:2](=[O:3])[O:6][CH3:5]",
        "[CH3:1][C:2](=[O:3])[OH:4].[NH2:5][CH3:6]>>"
        "[CH3:1][C:2](=[O:3])[NH:5][CH3:6]",
        "[Br:9][CH2:1][CH3:2].[NH2:3][CH3:4]>>[CH2:1]([CH3:2])[NH:3][CH3:4]",
        "[CH3:1][CH:2]([OH:5])[CH3:3]>>[CH3:1][CH:2]=[CH2:3]",
    ]
    root = str(tmp_path / "data")
    os.makedirs(root, exist_ok=True)
    all_ids = []
    for split, reps in (("train", 6), ("val", 1), ("test", 1)):
        rows = []
        for i, rxn in enumerate(rxns * reps):
            rid = f"{split}{i}"
            all_ids.append(rid)
            rows.append({
                "id": rid, "rxn_smiles": rxn,
                "product_smiles": canonical_product(
                    rxn.split(">")[-1], engine="native")[0],
                "reactant_smiles": demapped_canonical(
                    parse_smiles(rxn.split(">")[0])),
            })
        Table.from_records(rows).to_csv(os.path.join(root, f"{split}.csv"))
    Table.from_records([
        {"id": rid, "heading_text": "",
         "paragraph_text": f"the product was prepared from compound {rid} "
                           f"by heating."} for rid in all_ids]).to_csv(
        os.path.join(root, "corpus.csv"))
    write_text_vocab(os.path.join(root, "text_vocab.txt"))
    _write_configs(root, dict(TINY_ENC, vocab_size=700))
    override = [a for a in _tiny(root, "smiles_text", decoder=False)
                if a not in ("--max_dec_length", "16", "--num_beams", "3")]
    override += ["--vocab_file", "textreact_tpu_torch/assets/smiles_vocab.txt"]
    results = _smoke(tmp_path, "RetroSyn_tb", root, override)
    for art in ("atom_templates.csv", "bond_templates.csv",
                "template_infos.csv", "preprocessed_train.csv"):
        assert os.path.exists(os.path.join(tmp_path / "out", "templates",
                                           art))
    accs = results["accuracy"]
    assert isinstance(accs, list) and len(accs) == 2
    for acc in accs:
        assert set(int(k) for k in acc) == RETRO_KS
        assert all(0.0 <= v <= 1.0 for v in acc.values())


def _report(path, name, argv, capsys):
    """(exit code, printed report) of one checker, from a fresh module."""
    checker = _load(path, name)
    with pytest.raises(SystemExit) as e:
        checker.main(argv)
    return e.value.code, capsys.readouterr().out


@pytest.mark.parametrize("gap", ["none", "column", "nn_file", "scibert"])
def test_check_artifacts_reports_as_the_jax_checker(tmp_path, capsys, gap):
    """Both checkers on one fixture tree: the same ok/MISSING lines and exit
    code; the follow-up line names the port's parity_run.py instead of
    the JAX one, and nothing else differs."""
    from textreact_tpu_torch.utils.table import read_csv
    root = make_condition_data(str(tmp_path / "data"))
    for split in ("train", "val", "test"):
        os.symlink(os.path.join(root, f"{split}_nn.json"),
                   os.path.join(root, f"{split}.json"))
    argv = ["--recipe", "RCR", "--data_path", root,
            "--corpus_file", os.path.join(root, "corpus.csv"),
            "--nn_path", root, "--nn_prefix", ""]
    if gap == "column":
        table = read_csv(os.path.join(root, "val.csv"))
        del table.columns["solvent2"]
        table.to_csv(os.path.join(root, "val.csv"))
    elif gap == "nn_file":
        os.remove(os.path.join(root, "test.json"))
    elif gap == "scibert":
        argv += ["--scibert", str(tmp_path / "scibert")]
    jax_rc, jax_out = _report(JAX_CHECKER, "check_artifacts", argv, capsys)
    port_rc, port_out = _report(PORT_CHECKER, "torch_port_check_artifacts",
                                argv, capsys)
    assert port_rc == jax_rc == (0 if gap == "none" else 1)
    assert port_out != jax_out
    for jax_name, port_name in COMMANDS:
        jax_out = jax_out.replace(jax_name, port_name)
    assert port_out == jax_out
    assert ("MISSING" in port_out) == (gap != "none")


def test_check_artifacts_goldens_say_the_rdkit_halves_are_gated(capsys):
    rc, out = _report(PORT_CHECKER, "torch_port_check_artifacts",
                      ["--recipe", "goldens"], capsys)
    assert rc == 1
    assert "[MISSING] RDKit halves in the port" in out and "gated" in out
