"""The port's C++ host accelerators (tokenizers/native.py + _ctok.cpp,
chem/native.py + _cchem.cpp) on the CPU: token ids, fingerprint bits and
canonical strings equal to the JAX package's through both of its routes
and to the port's own Python route, on the cases of
tests/test_native_tokenizer.py and tests/test_native_chem.py, non-ASCII
text included; a failed build raises; processes that build at once load
one working library."""

import _torch_threads  # noqa: F401  (before torch runs)
import json
import os
import random
import string
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import textreact_tpu.chem as jax_chem
import textreact_tpu.tokenizers as jax_tok
import textreact_tpu_torch.chem as port_chem
import textreact_tpu_torch.tokenizers as port_tok
from test_chem_fuzz import DRUGS
from test_native_chem import SMILES as CHEM_CASES
from test_native_tokenizer import _vocab
from textreact_tpu.chem import native as jax_native
from textreact_tpu_torch.chem import native as port_native
from textreact_tpu_torch.evaluation.retro import compare_pred_and_gold
from textreact_tpu_torch.ops._build import build_host
from textreact_tpu_torch.tokenizers import native as port_tok_native

NON_ASCII = ["café acid", "中 with ab", "naïve x", "100 °C, 2 h", "µ-wave",
             "ab c", "C°C", "Cé", "c1ccccc1µ", "[Na+]·Cl"]
REACTIONS = ["CCO.CC(=O)O>>CC(=O)OCC", "CCO>>CCO", "CC(=O)OCC>>CCO.CC(=O)O",
             "Clc1ccccc1.CN>>CNc1ccccc1", "CC(=O)Cl.OCc1ccccc1>>CC(=O)OCc1ccccc1",
             "[Na+].[Cl-].C[C@H](N)C(=O)O>>C[C@@H](N)C(=O)OC",
             "CCO>CC(=O)O>CCOC(C)=O", "bad>>worse", "CCO>>", ""]
# a fragment that does not parse: the C++ route leaves it out of the
# difference, the Python route counts methane's fingerprint for it
UNPARSEABLE_FRAGMENT = ["CC>>C(", "CC>>C°", "C(>>CC", "CC.Q>>CC"]


def _text_cases():
    rng = random.Random(0)
    alphabet = (string.ascii_letters + string.digits + string.punctuation
                + " \t\n\r" + "\x01\x02\x7f")
    fuzz = ["".join(rng.choice(alphabet) for _ in range(rng.randrange(0, 60)))
            for _ in range(300)]
    rng = random.Random(1)
    frags = ["a", "b", "c", "ab", "x", "red", "stir", "1", "0", "q"]
    words = [" ".join("".join(rng.choice(frags)
                              for _ in range(rng.randrange(1, 5)))
                      for _ in range(rng.randrange(1, 10)))
             for _ in range(300)]
    fixtures = ["The reaction was STIRRED at room temperature.",
                "stirred, with acid", "xyzzy", "", "   ",
                "a-b-c (ab) x!? 10 21", "ab" * 60,
                "a\tb\nc\rwith\x00acid\x7f.", "!!!...???"]
    return {"fixtures": fixtures, "fuzz": fuzz, "wordlike": words,
            "non_ascii": NON_ASCII + [w + " é" for w in words[:50]]}


def _smiles_cases():
    rng = random.Random(2)
    alphabet = list("BCNOSPFIbcnosp()[].=#-+\\/:~@?>*$%0123456789rlHheKa ")
    fuzz = ["".join(rng.choice(alphabet) for _ in range(rng.randrange(0, 40)))
            for _ in range(300)]
    fixtures = ["CCO", "c1ccccc1", "C(=O)[O-].[Na+]", "Br/C=C\\Cl",
                "CC(C)Cl.BrBr>>CC(C)Br", "[13CH3][C@@H](N)C(=O)O",
                "C%12CC%12", "C1CC1", "*$~@?:#=-+", "", "C[C", "%1C", "%",
                "[unclosed", "[]", "N>S>>O", "zZ!illegal C", "Cl9%99c"]
    return {"fixtures": fixtures, "fuzz": fuzz, "non_ascii": NON_ASCII}


@pytest.mark.parametrize("case", ["fixtures", "fuzz", "wordlike",
                                  "non_ascii"])
def test_wordpiece_ids_equal_both_packages_both_routes(tmp_path, case):
    vocab = _vocab(str(tmp_path))
    tokenizers = [jax_tok.WordPieceTokenizer(vocab, native=True),
                  jax_tok.WordPieceTokenizer(vocab, native=False),
                  port_tok.WordPieceTokenizer(vocab),
                  port_tok.WordPieceTokenizer(vocab, native=False)]
    assert tokenizers[2]._native is not None
    assert tokenizers[3]._native is None
    for text in _text_cases()[case]:
        ids = [t(text)["input_ids"] for t in tokenizers]
        assert all(i == ids[0] for i in ids), repr(text)
        if not text.isascii():
            assert tokenizers[2]._native.encode(text) is None


@pytest.mark.parametrize("case", ["fixtures", "fuzz", "non_ascii"])
def test_smiles_ids_equal_both_packages_both_routes(case):
    tokenizers = [jax_tok.SmilesTokenizer(native=True),
                  jax_tok.SmilesTokenizer(native=False),
                  port_tok.SmilesTokenizer(),
                  port_tok.SmilesTokenizer(native=False)]
    assert tokenizers[2]._native is not None
    for smiles in _smiles_cases()[case]:
        ids = [t(smiles)["input_ids"] for t in tokenizers]
        assert all(i == ids[0] for i in ids), repr(smiles)
        pair = [t("CCO", text_pair=smiles)["input_ids"] for t in tokenizers]
        assert all(i == pair[0] for i in pair), repr(smiles)


def test_one_encoder_serves_two_threads(tmp_path):
    """The loader's thread and the main thread may encode at once: each
    has its own output buffer, and long texts grow it."""
    from concurrent.futures import ThreadPoolExecutor
    vocab = _vocab(str(tmp_path))
    nat = port_tok.WordPieceTokenizer(vocab)
    py = port_tok.WordPieceTokenizer(vocab, native=False)
    texts = [" ".join(["stirred with acid at room temperature"] * n)
             for n in range(1, 2000, 97)]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(lambda t: nat(t)["input_ids"], texts * 4))
    assert got == [py(t)["input_ids"] for t in texts * 4]
    assert max(map(len, got)) > 8192


@pytest.mark.parametrize("source", ["native_cases", "drugs", "non_ascii"])
def test_fingerprints_and_canonical_smiles_equal_both_routes(source):
    mols = {"native_cases": CHEM_CASES, "drugs": DRUGS,
            "non_ascii": NON_ASCII}[source]
    for smi in mols:
        for counts in (False, True):
            ref = jax_chem.morgan_fingerprint(smi, counts=counts)
            for got in (jax_native.native_morgan_fingerprint(smi,
                                                             counts=counts),
                        port_native.native_morgan_fingerprint(smi,
                                                              counts=counts),
                        port_chem.morgan_fingerprint(smi, counts=counts)):
                assert got.dtype == ref.dtype and np.array_equal(got, ref), smi
        strings = {jax_chem.canonical_smiles(smi),
                   jax_native.native_canonical_smiles(smi),
                   port_native.native_canonical_smiles(smi),
                   port_chem.canonical_smiles(smi)}
        assert len(strings) == 1, (smi, strings)
    valid = [s for s in mols if s]
    matrix = port_chem.fingerprint_matrix(valid)
    assert matrix.dtype == np.uint8
    np.testing.assert_array_equal(
        matrix, port_chem.fingerprint_matrix(valid, native=False))
    np.testing.assert_array_equal(
        matrix, jax_native.native_morgan_batch(valid).astype(np.uint8))
    assert port_native.native_canonical_batch(list(mols)) == \
        [port_chem.canonical_smiles(s) for s in mols]
    assert port_native.native_canonical_batch([]) == []


@pytest.mark.parametrize("workers", [0, 2])
def test_reaction_fingerprints_equal_both_routes(workers):
    got = port_chem.fingerprint_matrix(REACTIONS, "reaction",
                                       num_workers=workers)
    assert got.dtype == np.int32 and got.shape == (len(REACTIONS), 2048)
    np.testing.assert_array_equal(got, port_chem.fingerprint_matrix(
        REACTIONS, "reaction", native=False))
    np.testing.assert_array_equal(got, jax_chem.fingerprint_matrix(
        REACTIONS, "reaction"))
    for rxn, row in zip(REACTIONS, got):
        try:
            ref = jax_native.native_reaction_fingerprint(rxn)
        except ValueError:
            ref = np.zeros(2048, np.int32)
        np.testing.assert_array_equal(row, ref)


def test_reaction_fragment_that_does_not_parse_parts_the_routes():
    """A quirk of the reference, mirrored: the JAX package's C++ route
    leaves an unparseable fragment out of the difference, its Python route
    counts methane for it; each of the port's routes gives its twin's."""
    for rxn in UNPARSEABLE_FRAGMENT:
        native = port_native.native_reaction_fingerprint(rxn)
        python = port_chem.reaction_difference_fingerprint(rxn)
        np.testing.assert_array_equal(
            native, jax_native.native_reaction_fingerprint(rxn))
        np.testing.assert_array_equal(
            python, jax_chem.reaction_difference_fingerprint(rxn))
        assert not np.array_equal(native, python), rxn


def test_retro_metric_ranks_through_both_routes():
    gold = port_chem.canonical_smiles("C(C)O")
    beams = [["CCC", "OCC", "C(C)O"], ["garbage(((", "", "OCC"],
             ["CCN", "c1ccccc1"], list(NON_ASCII) + ["CCO"]]
    for pred in beams:
        assert compare_pred_and_gold(pred, gold) == \
            compare_pred_and_gold(pred, gold, native=False)


def test_failed_build_raises_with_the_compilers_output(tmp_path):
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        build_host(tmp_path / "missing.cpp", "missing", build_dir=tmp_path)
    assert "missing.cpp" in str(info.value)
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="error"):
        build_host(bad, "bad", build_dir=tmp_path)
    assert not list(tmp_path.glob("*.tmp")) and not (
        tmp_path / "libbad.so").exists()


BUILD_AND_ENCODE = """
import ctypes, sys
from pathlib import Path
from textreact_tpu_torch.ops._build import build_host
lib = ctypes.CDLL(str(build_host(Path(sys.argv[1]), "ctok", Path(sys.argv[2]))))
lib.ctok_encoder_new.restype = ctypes.c_int32
lib.ctok_encode.restype = ctypes.c_int32
vocab = [b"[UNK]", b"ab", b"##c"]
offs = (ctypes.c_int32 * 4)(0, 5, 7, 10)
ids = (ctypes.c_int32 * 3)(0, 1, 2)
h = lib.ctok_encoder_new(b"".join(vocab), offs, ids, 3, 0)
out = (ctypes.c_int32 * 16)()
n = lib.ctok_encode(h, b"abc x", 5, 100, 1, out, 16)
print(list(out[:n]))
"""


def test_processes_building_at_once_load_one_library(tmp_path):
    """Two processes reach a stale library together: one builds under the
    lock, the other waits and loads what it built; a newer source is
    built again."""
    src = tmp_path / "_ctok.cpp"
    src.write_bytes(Path(port_tok_native._SRC).read_bytes())
    build = tmp_path / "build"
    root = str(Path(__file__).resolve().parent.parent)
    cmd = [sys.executable, "-c", BUILD_AND_ENCODE, str(src), str(build)]
    procs = [subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert json.loads(out) == [1, 2, 0]
    lib = build / "libctok.so"
    first = lib.stat().st_mtime_ns
    assert not list(build.glob("*.tmp"))
    os.utime(src, ns=(first + 10**9, first + 10**9))
    build_host(src, "ctok", build)
    assert lib.stat().st_mtime_ns > first
