"""The port's retrieval path against the JAX package's, on the CPU.

Same numpy inputs from a seed through both packages; results must be EQUAL
(tolerance 0: the function is integer arithmetic with a fixed tie order).
The JAX side runs its Pallas kernels in interpret mode with small tiles; the
port runs the plain version of its CUDA kernels (`device="cpu"`).
"""

import _torch_threads  # noqa: F401  (before torch runs)
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import textreact_tpu.ops.topk as jax_topk
import textreact_tpu.retrieval as jax_retrieval
import textreact_tpu.retrieval.cli as jax_cli
import textreact_tpu.retrieval.debug_cli as jax_debug_cli
import textreact_tpu_torch.ops.topk as port_topk
import textreact_tpu_torch.retrieval as port_retrieval
import textreact_tpu_torch.retrieval.cli as port_cli
import textreact_tpu_torch.retrieval.debug_cli as port_debug_cli
from textreact_tpu_torch.retrieval import engine as port_engine
from textreact_tpu_torch.utils.table import read_csv

from fixtures import make_condition_data, make_retro_data

BIG = port_topk.BIG


def _binary(n, d, seed, density=0.1):
    return (np.random.default_rng(seed).random((n, d)) < density
            ).astype(np.int8)


def _counts(n, d, seed, lo=-5, hi=6):
    return np.random.default_rng(seed).integers(lo, hi, (n, d)).astype(np.int8)


def _tied(seed):
    """128 rows in blocks of 16 duplicates, shuffled: heavy ties that cross
    every tile boundary."""
    base = _binary(8, 128, seed)
    corpus = np.repeat(base, 16, axis=0)
    corpus = corpus[np.random.default_rng(seed).permutation(len(corpus))]
    return base[:5], corpus


def _case(name):
    """(queries, corpus, banned, k)"""
    if name == "binary_ragged":
        return _binary(37, 256, 2), _binary(601, 256, 1), None, 20
    if name == "ties":
        q, c = _tied(3)
        return q, c, None, 20
    if name == "banned_nb1":
        c = _binary(300, 256, 4)
        return c[:16].copy(), c, np.arange(16, dtype=np.int32)[:, None], 5
    if name == "banned_nb3":
        c = _binary(90, 128, 5)
        banned = np.stack([np.arange(6), np.arange(6) + 10,
                           np.full(6, -1)], axis=1).astype(np.int32)
        return c[:6].copy(), c, banned, 8
    if name == "banned_ties":
        q, c = _tied(6)
        banned = np.stack([np.arange(5) * 7, np.arange(5) * 11 + 1],
                          axis=1).astype(np.int32)
        return q, c, banned, 20
    if name == "negative_counts":
        return _counts(12, 256, 9), _counts(200, 256, 8), None, 7
    if name == "corpus_smaller_than_k":
        c = _binary(5, 128, 0, 0.2)
        return c[:3].copy(), c, None, 20
    if name == "single_row_corpus":
        return (np.zeros((2, 128), np.int8), np.ones((1, 128), np.int8),
                None, 3)
    if name == "k1":
        return _counts(9, 128, 11), _counts(70, 128, 10), None, 1
    if name == "k256":  # past the card's shared-memory lists (128)
        c = _binary(700, 128, 12)
        banned = np.stack([np.arange(6), np.full(6, -1)],
                          axis=1).astype(np.int32)
        return c[:6].copy(), c, banned, 256
    raise KeyError(name)


CASES = ["binary_ragged", "ties", "banned_nb1", "banned_nb3", "banned_ties",
         "negative_counts", "corpus_smaller_than_k", "single_row_corpus",
         "k1", "k256"]


def _jax_topk(queries, corpus, banned, k, corpus_resident, tile_q=8,
              tile_c=32):
    """The JAX kernel as its engine calls it: rows padded to the tiles,
    padding rows marked by a BIG norm, interpret mode."""
    M = len(queries)
    q = jax_topk.pad_matrix(queries, tile_q)
    c = jax_topk.pad_matrix(corpus, tile_c)
    norms = jax_topk.corpus_norms_padded(c, len(corpus))
    nb = 1 if banned is None else banned.shape[1]
    b = np.full((len(q), nb), -1, np.int32)
    if banned is not None:
        b[:M] = banned
    vals, idx = jax_topk.exact_topk_l2(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(norms), jnp.asarray(b),
        k=k, tile_q=tile_q, tile_c=tile_c, interpret=True,
        corpus_resident=corpus_resident)
    return np.asarray(vals)[:M], np.asarray(idx)[:M]


def _port_topk(queries, corpus, banned, k, corpus_resident):
    norms = port_topk.corpus_norms_padded(corpus, len(corpus))
    vals, idx = port_topk.exact_topk_l2(
        torch.from_numpy(queries), torch.from_numpy(corpus),
        torch.from_numpy(norms),
        None if banned is None else torch.from_numpy(banned), k=k,
        corpus_resident=corpus_resident)
    assert vals.dtype == idx.dtype == torch.int32
    return vals.numpy(), idx.numpy()


@pytest.mark.parametrize("corpus_resident", [False, True],
                         ids=["query_outer", "corpus_resident"])
@pytest.mark.parametrize("case", CASES)
def test_exact_topk_equals_pallas_kernel(case, corpus_resident):
    queries, corpus, banned, k = _case(case)
    ref_v, ref_i = _jax_topk(queries, corpus, banned, k, corpus_resident)
    got_v, got_i = _port_topk(queries, corpus, banned, k, corpus_resident)
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_v, ref_v)
    if len(corpus) < k:  # unfilled slots: (BIG + |q|^2, BIG)
        qn = (queries.astype(np.int64) ** 2).sum(1)
        assert (got_i[:, len(corpus):] == BIG).all()
        np.testing.assert_array_equal(
            got_v[:, len(corpus):],
            np.broadcast_to((BIG + qn)[:, None],
                            got_v[:, len(corpus):].shape))


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c != "corpus_smaller_than_k"])
def test_plain_version_equals_both_numpy_oracles(case):
    queries, corpus, banned, k = _case(case)
    k = min(k, len(corpus))
    got_v, got_i = _port_topk(queries, corpus, banned, k, False)
    for oracle in (jax_topk.numpy_reference_topk,
                   port_topk.numpy_reference_topk):
        ref_v, ref_i = oracle(queries, corpus, k, banned)
        np.testing.assert_array_equal(got_i, ref_i)
        np.testing.assert_array_equal(got_v, ref_v)


def test_plain_version_is_exact_beyond_float32():
    """d * max|q| * max|c| >= 2^24: the product runs in float64."""
    rng = np.random.default_rng(0)
    corpus = rng.integers(-127, 128, (300, 2048)).astype(np.int8)
    queries = rng.integers(-127, 128, (7, 2048)).astype(np.int8)
    corpus[17] = corpus[3]  # a tie
    queries[0] = corpus[3]
    got_v, got_i = _port_topk(queries, corpus, None, 10, False)
    ref_v, ref_i = port_topk.numpy_reference_topk(queries, corpus, 10)
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_v, ref_v)
    assert list(got_i[0, :2]) == [3, 17] and got_v[0, 0] == 0


def test_helpers_match():
    x = _counts(5, 100, 0)
    for rows, cols in ((8, 128), (1, 16), (5, 100)):
        np.testing.assert_array_equal(port_topk.pad_matrix(x, rows, cols),
                                      jax_topk.pad_matrix(x, rows, cols))
    padded = port_topk.pad_matrix(x, 8)
    np.testing.assert_array_equal(port_topk.corpus_norms_padded(padded, 5),
                                  jax_topk.corpus_norms_padded(padded, 5))
    assert port_topk.BIG == jax_topk.BIG


def test_wrapper_takes_the_kernel_on_cuda_tensors_only():
    """On the CPU the wrapper runs the plain version and counts no launch."""
    before = dict(port_topk.LAUNCHES)
    _port_topk(*_case("k1"), True)
    assert port_topk.LAUNCHES == before
    assert set(before) == {"query_outer", "corpus_split"}


@pytest.mark.parametrize("corpus_resident", [None, False, True])
@pytest.mark.parametrize("case", ["binary_ragged", "banned_nb3",
                                  "negative_counts",
                                  "corpus_smaller_than_k", "k256"])
def test_flat_index_search_equals_jax(case, corpus_resident):
    queries, corpus, banned, k = _case(case)
    ref = jax_retrieval.FlatIndex(
        corpus, tile_q=8, tile_c=32,
        corpus_resident=corpus_resident).search(queries, k=k, banned=banned)
    index = port_retrieval.FlatIndex(corpus, device="cpu",
                                     corpus_resident=corpus_resident)
    got = index.search(queries, k=k, banned=banned)
    for g, r in zip(got, ref):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, r)
    assert index.corpus.dtype == torch.int8
    assert index.norms.dtype == torch.int32
    if len(corpus) >= k:
        oracle = index.reference_search(queries, k=k, banned=banned)
        np.testing.assert_array_equal(got[1], oracle[1])


def test_flat_index_odd_width_and_chunked_queries(monkeypatch):
    """d is no multiple of 16 (zero columns are added) and the query set is
    searched in several chunks."""
    corpus, queries = _counts(150, 100, 1), _counts(300, 100, 2)
    index = port_retrieval.FlatIndex(corpus, device="cpu")
    assert index.dim == 112
    whole = index.search(queries, k=6)
    monkeypatch.setattr(port_engine, "SEARCH_BUDGET_BYTES", 128 * 200)
    assert index.max_queries(6, 1) == 128
    chunked = index.search(queries, k=6)
    ref = jax_topk.numpy_reference_topk(queries, corpus, 6)
    for a, b, r in zip(whole, chunked, ref):
        np.testing.assert_array_equal(a, r)
        np.testing.assert_array_equal(b, r)


def test_flat_index_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_retrieval.FlatIndex(_binary(4, 128, 0))


def test_build_neighbor_file_equals_jax():
    corpus = _binary(6, 128, 2, 0.2)
    train_ids = [f"id{i}" for i in range(6)]
    ref = jax_retrieval.build_neighbor_file(
        ["q0", "q1"], train_ids,
        jax_retrieval.FlatIndex(corpus, tile_q=8, tile_c=8), corpus[:2], k=10)
    got = port_retrieval.build_neighbor_file(
        ["q0", "q1"], train_ids,
        port_retrieval.FlatIndex(corpus, device="cpu"), corpus[:2], k=10)
    assert got == ref and len(got[0]["nn"]) == 6


@pytest.mark.parametrize("with_banned", [False, True])
def test_merge_topk_equals_jax_sharded_search(with_banned):
    """The corpus cut in 8 on the port's side, each part searched, the
    partial lists merged: equal to the JAX engine over its 8-device mesh."""
    devices = np.array(jax.devices()[:8])
    assert devices.size == 8, "conftest must provide 8 fake CPU devices"
    corpus = np.repeat(_binary(250, 256, 5), 4, axis=0)  # ties across shards
    corpus = corpus[np.random.default_rng(0).permutation(len(corpus))]
    queries = _binary(30, 256, 6)
    banned = None
    if with_banned:
        banned = np.stack([np.arange(30) * 3, np.arange(30) * 31 % 1000],
                          axis=1).astype(np.int32)
    k = 20
    mesh = Mesh(devices, (jax_retrieval.CORPUS_AXIS,))
    ref = jax_retrieval.FlatIndex(corpus, mesh=mesh, tile_q=8, tile_c=32
                                  ).search(queries, k=k, banned=banned)
    parts = []
    rows = len(corpus) // 8
    for s in range(8):
        index = port_retrieval.FlatIndex(corpus[s * rows:(s + 1) * rows],
                                         device="cpu")
        vals, idx = index.search(
            queries, k=k, banned=None if banned is None else banned - s * rows)
        parts.append((vals, np.where(idx >= BIG, idx, idx + s * rows)))
    vals, idx = port_retrieval.merge_topk(parts, k)
    np.testing.assert_array_equal(idx.numpy(), ref[1])
    np.testing.assert_array_equal(vals.numpy(), ref[0])


def test_merge_topk_keeps_unfilled_slots_last():
    a = (np.array([[5, BIG + 3]], np.int32), np.array([[7, BIG]], np.int32))
    b = (np.array([[5, 9]], np.int32), np.array([[2, 11]], np.int32))
    vals, idx = port_retrieval.merge_topk([a, b], 4)
    assert idx.tolist() == [[2, 7, 11, BIG]]
    assert vals.tolist() == [[5, 5, 9, BIG + 3]]


SMILES = ["CC(=O)Cl", "OCc1ccccc1", "c1ccc2[nH]ccc2c1", "C[C@H](N)C(=O)O",
          "[Na+].[Cl-]", "not a smiles", "", "C"]
REACTIONS = ["CC(=O)Cl.OCc1ccccc1>>CC(=O)OCc1ccccc1",
             "Brc1ccccc1.OB(O)c1ccccc1>>c1ccc(-c2ccccc2)cc1",
             "CCO>CC(=O)O>CCOC(C)=O", "CCO", "bad>>worse", ""]


def _fixture_column(tmp_path, maker, field):
    root = maker(str(tmp_path / "data"))
    return read_csv(os.path.join(root, "train.csv"))[field]


@pytest.mark.parametrize("kind", ["reaction", "molecule"])
def test_fingerprints_equal_jax(tmp_path, kind):
    if kind == "reaction":
        smiles = REACTIONS + _fixture_column(tmp_path, make_condition_data,
                                             "canonical_rxn")
        ref = jax_retrieval.reaction_fingerprints(smiles)
        got = port_retrieval.reaction_fingerprints(smiles)
        assert got.shape == (len(smiles), 2048) and got.min() < 0
    else:
        smiles = SMILES + _fixture_column(tmp_path, make_retro_data,
                                          "product_smiles")
        ref = jax_retrieval.molecule_fingerprints(smiles)
        got = port_retrieval.molecule_fingerprints(smiles)
        assert got.shape == (len(smiles), 1024) and got.max() == 1
    assert got.dtype == ref.dtype == np.int8
    np.testing.assert_array_equal(got, ref)


def test_similarity_helpers_equal_jax():
    fps = _counts(20, 64, 0)
    bits = _binary(20, 64, 1, 0.3).astype(np.uint8)
    np.testing.assert_array_equal(
        port_retrieval.count_tanimoto_similarities(fps[0], fps),
        jax_retrieval.count_tanimoto_similarities(fps[0], fps))
    np.testing.assert_array_equal(
        port_retrieval.tanimoto_similarities(bits[0], bits),
        jax_retrieval.tanimoto_similarities(bits[0], bits))
    sims = port_retrieval.count_tanimoto_similarities(fps[0], fps)
    assert port_retrieval.brute_force_rank(sims, 5) \
        == jax_retrieval.brute_force_rank(sims, 5)


def _cli_args(task, root, out):
    if task == "condition":
        return ["--data_path", root, "--train_file", "train.csv",
                "--valid_file", "val.csv", "--test_file", "test.csv",
                "--field", "canonical_rxn", "--output_path", out, "--k", "5",
                "--check_parity"]
    return ["--data_path", root, "--train_file", "train.csv",
            "--valid_file", "valid.csv", "--test_file", "test.csv",
            "--field", "product_smiles", "--output_path", out, "--k", "4",
            "--before", "2010", "--check_parity"]


@pytest.mark.parametrize("task", ["condition", "retro"])
def test_retrieval_cli_writes_the_same_files(tmp_path, capsys, task):
    maker = make_condition_data if task == "condition" else make_retro_data
    root = maker(str(tmp_path / "data"))
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_cli.main(_cli_args(task, root, jax_out))
    jax_report = capsys.readouterr().out
    port_cli.main(_cli_args(task, root, port_out) + ["--device", "cpu"])
    port_report = capsys.readouterr().out
    for name in ("train.json", "val.json", "test.json"):
        a = open(os.path.join(jax_out, name), "rb").read()
        b = open(os.path.join(port_out, name), "rb").read()
        assert a == b, name
        assert all(len(r["nn"]) == (5 if task == "condition" else 4)
                   for r in json.loads(b))
    np.testing.assert_array_equal(
        np.load(os.path.join(jax_out, "train_fp.npy")),
        np.load(os.path.join(port_out, "train_fp.npy")))
    assert port_report == jax_report
    assert ("Top-1" in port_report) == (task == "condition")
    # second run: the cached fingerprints are loaded, the files do not change
    port_cli.main(_cli_args(task, root, port_out) + ["--device", "cpu"])
    assert open(os.path.join(port_out, "test.json"), "rb").read() \
        == open(os.path.join(jax_out, "test.json"), "rb").read()


def test_retrieval_cli_refuses_what_is_not_ported(tmp_path):
    """--shard_corpus is ported: with --device cpu it searches two shards
    and writes the files of the unsharded run byte for byte. Without a card
    and without --device the command still refuses."""
    root = make_condition_data(str(tmp_path / "data"))
    args = _cli_args("condition", root, str(tmp_path / "out"))
    port_cli.main(args + ["--device", "cpu"])
    sharded = _cli_args("condition", root, str(tmp_path / "out_sharded"))
    port_cli.main(sharded + ["--device", "cpu", "--shard_corpus"])
    for name in ("train.json", "val.json", "test.json"):
        assert (open(os.path.join(tmp_path, "out", name), "rb").read()
                == open(os.path.join(tmp_path, "out_sharded", name),
                        "rb").read()), name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli.main(args)


def test_read_csv_infers_types_as_pandas_does(tmp_path):
    import pandas as pd
    text = ("id,year,frac,mixed,empty,name\n"
            "1,2001,0.5,3,,a b\n"
            "02,1999,2,x,,\"c,d\"\n"
            " 3 ,2010,1e3,4.5,,\n")
    path = tmp_path / "t.csv"
    path.write_text(text)
    table = read_csv(str(path))
    frame = pd.read_csv(io.StringIO(text), keep_default_na=False)
    assert len(table) == len(frame) == 3
    for name in frame.columns:
        assert table[name] == list(frame[name]), name
        assert [type(v) for v in table[name]] \
            == [type(v) for v in frame[name].tolist()], name
    assert json.dumps(table["id"]) == "[1, 2, 3]"
    assert table.row(1)["name"] == "c,d"
    assert table.take([True, False, True])["year"] == [2001, 2010]


def test_convert_tevatron_equals_jax(tmp_path):
    records = [{"query_id": "q1",
                "negative_passages": [{"docid": "a"}, {"docid": "b"}]},
               {"query_id": "q2", "negative_passages": [{"docid": "c"}]}]
    inp = tmp_path / "in.jsonl"
    inp.write_text("".join(json.dumps(r) + "\n" for r in records) + "\n")
    outs = []
    for fn, name in ((jax_retrieval.convert_tevatron_jsonl, "jax.json"),
                     (port_retrieval.convert_tevatron_jsonl, "port.json")):
        assert fn(str(inp), str(tmp_path / name)) == 2
        outs.append((tmp_path / name).read_bytes())
    assert outs[0] == outs[1]
    assert json.loads(outs[1])[0] == {"id": "q1", "nn": ["a", "b"]}


def test_debug_cli_equals_jax(tmp_path):
    (tmp_path / "train.csv").write_text(
        "canonical_rxn\nCCO>>CCN\nCC>>CO\nCCC>>CCO\n")
    (tmp_path / "test.csv").write_text("canonical_rxn\nCCO>>CCN\nCC>>CN\n")
    outs = []
    for main, name in ((jax_debug_cli.main, "jax.json"),
                       (port_debug_cli.main, "port.json")):
        main(["--train_file", str(tmp_path / "train.csv"),
              "--test_file", str(tmp_path / "test.csv"),
              "--output", str(tmp_path / name), "--limit", "2", "--top", "3"])
        outs.append((tmp_path / name).read_bytes())
    assert outs[0] == outs[1]
    data = json.loads(outs[1])
    assert data["0"]["rank"][0] == 0 and data["0"]["similarity"][0] == 1.0
