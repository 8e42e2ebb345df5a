"""The port's recipe scripts (scripts/torch_port/train_*.sh,
retrieve_scripts/torch_port/*.sh) against the JAX package's: each names its
JAX twin's flags and values, in order, but for the substitutions below, and
its command line parses with the port's own parser."""

import _torch_threads  # noqa: F401  (before torch runs)
import os
import shlex

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = ["train_RCR", "train_RCR_TS", "train_RetroSyn_tf",
           "train_RetroSyn_tf_TS", "train_RetroSyn_tb",
           "train_RetroSyn_tb_TS"]
RETRIEVALS = ["condition_year", "retro", "retro_year"]
# the JAX value of a flag -> the port's
MODULES = {"textreact_tpu.cli.main": "textreact_tpu_torch",
           "textreact_tpu.retrieval.cli": "textreact_tpu_torch.retrieval.cli"}
VALUES = {
    # the port downloads nothing: the local SciBERT directory that
    # models/import_hf.py reads, the one --text_vocab_file names
    ("--encoder", "allenai/scibert_scivocab_uncased"):
        "data/scibert_scivocab_uncased",
    ("--decoder", "textreact_tpu/models/configs/bert_l6.json"): "bert_l6",
}
ASSETS = ("textreact_tpu/assets/", "textreact_tpu_torch/assets/")


def _script(path):
    """(variables assigned, module run by `python -m`, [(flag, value or
    None)]) of a recipe script."""
    text = open(path).read().replace("\\\n", " ")
    variables, command = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("python -m "):
            command = shlex.split(line)
        elif "=" in line and not line.startswith(("#", "mkdir")):
            name, value = line.split("=", 1)
            variables[name] = value
    assert command is not None, path
    flags = []
    for word in command[3:]:
        if word.startswith("--"):
            flags.append([word, None])
        else:
            assert flags[-1][1] is None, (path, word)
            flags[-1][1] = word
    return variables, command[2], [tuple(f) for f in flags]


def _ported(flags):
    out = []
    for flag, value in flags:
        value = VALUES.get((flag, value), value)
        if value is not None:
            value = value.replace(*ASSETS)
        out.append((flag, value))
    return out


def _pairs():
    return ([(os.path.join("scripts", f"{n}.sh"),
              os.path.join("scripts", "torch_port", f"{n}.sh"))
             for n in RECIPES]
            + [(os.path.join("retrieve_scripts", f"{n}.sh"),
                os.path.join("retrieve_scripts", "torch_port", f"{n}.sh"))
               for n in RETRIEVALS])


@pytest.mark.parametrize("jax_path,port_path", _pairs(),
                         ids=RECIPES + RETRIEVALS)
def test_script_names_its_jax_twins_flags(jax_path, port_path):
    jax_vars, jax_module, jax_flags = _script(os.path.join(REPO, jax_path))
    port_vars, port_module, port_flags = _script(
        os.path.join(REPO, port_path))
    assert os.access(os.path.join(REPO, port_path), os.X_OK)
    assert port_vars == jax_vars
    assert port_module == MODULES[jax_module]
    assert port_flags == _ported(jax_flags)
    argv = [w.replace("${SAVE_PATH}", port_vars.get("SAVE_PATH", ""))
             .replace("${NN_PATH}", port_vars.get("NN_PATH", ""))
            for flag in port_flags for w in flag if w is not None]
    if port_module == "textreact_tpu_torch":
        from textreact_tpu_torch.cli.main import parse_config
        from textreact_tpu_torch.models.config import resolve_config
        cfg = parse_config(argv)
        flags = dict(port_flags)
        # the vocab the encoder's directory holds, and the assets exist
        assert os.path.dirname(flags["--text_vocab_file"]) == cfg.encoder
        assert os.path.isfile(os.path.join(REPO, cfg.vocab_file))
        if cfg.decoder is not None:
            assert resolve_config(cfg.decoder).num_hidden_layers == 6
    else:
        from textreact_tpu_torch.retrieval.cli import get_args
        assert get_args(argv).k == 20
