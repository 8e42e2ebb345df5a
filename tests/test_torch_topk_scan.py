"""The exact top-k scan of csrc/exact_topk.cu, stated in plain PyTorch, and
its planner, on the CPU.

The CUDA scan cannot run here. What can be held here is how it walks and
selects: `scan_plan` below (the work items each persistent block takes, as
topk_scan and tr_topk_corpus_split cut them), the slab count against the
search budget, the plan of the scan's shared memory for every k
(`topk.scan_layout`), and a statement of the selection written the way the
kernel does it: tiles of 128 corpus rows in ascending order inside each
slab, a hot test of each row's least 32-bit score against the row's k-th
score (strict `<`), and only on the rare path the padding rows, the columns
past the slab's end, the banned ids and the 64-bit keys, inserted smallest
first up to k = 128 and past it gathered into runs of 32 that merge into
the list (work items of 64 queries there). That statement
lives here, not on the main path, and is held to the numpy oracle and to
the JAX package's Pallas kernel in interpret mode, with tolerance 0, on
inputs made to break it: equal rows across tile and slab boundaries and at
the k-th place, rows whose candidates are all banned, fewer rows than k,
tiles of more candidates than a run holds.
The kernel's own walk and its ring are held on the card, in
tests/test_torch_cuda_kernels.py: several items a block in both layouts
against the plain version, and the ring's stages beside the lists.
"""

import _torch_threads  # noqa: F401  (before torch runs)
import bisect
import heapq

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import textreact_tpu.ops.topk as jax_topk
from textreact_tpu_torch.ops import topk
from textreact_tpu_torch.retrieval.engine import (SEARCH_BUDGET_BYTES,
                                                  FlatIndex)

BIG = topk.BIG
EMPTY = (BIG << 32) | BIG


def _int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32, as the kernel's 32-bit arithmetic."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def slab_rows(n: int, slabs: int) -> int:
    """Corpus rows of a slab as tr_topk_corpus_split cuts the corpus: whole
    tiles; the last slabs may be short or empty."""
    return _cdiv(_cdiv(n, topk.TILE_C), slabs) * topk.TILE_C


def scan_plan(m: int, n: int, slabs: int, blocks: int,
              tile_q: int = topk.TILE_Q):
    """The scan kernel's work as topk_scan walks it: for each launched block
    (min(items, blocks) of them), its items blockIdx, blockIdx + grid, ...
    in order, each (query tile of `tile_q`, slab, first corpus row, end
    row). Items are numbered slab-major, so the blocks that run together
    read one slab."""
    q_tiles, rows = _cdiv(m, tile_q), slab_rows(n, slabs)
    items = q_tiles * slabs
    grid = min(items, blocks)
    return [[(it % q_tiles, it // q_tiles, min(it // q_tiles * rows, n),
              min(it // q_tiles * rows + rows, n))
             for it in range(b, items, grid)] for b in range(grid)]


def merge_runs(lst, keys, k, banned_row):
    """The large-k rare path of one row and tile (rare_row_merge): its
    candidates `keys`, ascending, gathered into runs of at most topk.RUN; a
    candidate j of a run enters only below the list's (k - 1 - j)-th key
    (the first that does not ends the row), a banned one is skipped; each
    run merges into `lst` (merge_run), the next run is held to the merged
    list."""
    i = 0
    while i < len(keys):
        run, stop = [], False
        while i < len(keys) and len(run) < topk.RUN:
            if not keys[i] < lst[k - 1 - len(run)]:
                stop = True
                break
            if (keys[i] & 0xffffffff) not in banned_row:
                run.append(keys[i])
            i += 1
        lst[:] = list(heapq.merge(lst, run))[:k]
        if stop:
            break


def scan_statement(queries, corpus, norms, banned, k, slabs, blocks=3):
    """The scan kernel's selection and the merge, in plain PyTorch: returns
    (vals, idx) as the kernels do, and how many (row, tile) pairs took the
    rare path. Work items of the plan's queries (topk.scan_layout); up to
    topk.INSERT_K a candidate enters by one insertion, past it by runs."""
    M, N = len(queries), len(corpus)
    tile_q = topk.scan_layout(k).queries
    q = torch.from_numpy(queries).long()
    c = torch.from_numpy(corpus).long()
    cn_all = torch.from_numpy(norms).long()
    partial = [[[EMPTY] * k for _ in range(M)] for _ in range(slabs)]
    rare = 0
    for items in scan_plan(M, N, slabs, blocks, tile_q):
        for qt, slab, c_begin, c_end in items:
            rows = range(qt * tile_q, min((qt + 1) * tile_q, M))
            lists = {r: [EMPTY] * k for r in rows}
            for c0 in range(c_begin, c_end, topk.TILE_C):
                cols = torch.arange(c0, c0 + topk.TILE_C)
                inside = cols < c_end
                tile = torch.zeros((topk.TILE_C, q.shape[1]), dtype=torch.long)
                tile[: min(N - c0, topk.TILE_C)] = c[c0:c0 + topk.TILE_C]
                cn = torch.where(inside, cn_all[cols.clamp(max=N - 1)], BIG)
                dots = q[list(rows)] @ tile.T
                score = _int32(cn[None, :] - 2 * dots)
                kth = torch.tensor([lists[r][k - 1] >> 32 for r in rows])
                hot = score.min(1).values < kth          # 32-bit, strict
                for i in torch.nonzero(hot).flatten().tolist():
                    rare += 1
                    r = rows[i]
                    lst = lists[r]
                    ok = (score[i] < kth[i]) & (cn < BIG)  # padding, slab end
                    keys = sorted((int(score[i, j]) << 32) | (c0 + j)
                                  for j in torch.nonzero(ok).flatten().tolist())
                    if k > topk.INSERT_K:
                        merge_runs(lst, keys, k, () if banned is None
                                   else set(banned[r].tolist()))
                        continue
                    for key in keys:                       # smallest first
                        if not key < lst[k - 1]:
                            break
                        if banned is not None and (key & 0xffffffff) in banned[r]:
                            continue
                        bisect.insort(lst, key)
                        lst.pop()
            for r in rows:
                partial[slab][r] = lists[r]
    qn = (q ** 2).sum(1)
    vals = np.empty((M, k), np.int32)
    idx = np.empty((M, k), np.int32)
    for r in range(M):
        merged = sorted(key for s in range(slabs) for key in partial[s][r])[:k]
        vals[r] = [(key >> 32) + int(qn[r]) for key in merged]
        idx[r] = [key & 0xffffffff for key in merged]
    return vals, idx, rare


def _jax(queries, corpus, banned, k):
    """The Pallas kernel in interpret mode, as its engine calls it."""
    M = len(queries)
    qp = jax_topk.pad_matrix(queries, 8)
    cp = jax_topk.pad_matrix(corpus, 32)
    norms = jax_topk.corpus_norms_padded(cp, len(corpus))
    nb = 1 if banned is None else banned.shape[1]
    b = np.full((len(qp), nb), -1, np.int32)
    if banned is not None:
        b[:M] = banned
    vals, idx = jax_topk.exact_topk_l2(
        jnp.asarray(qp), jnp.asarray(cp), jnp.asarray(norms), jnp.asarray(b),
        k=k, tile_q=8, tile_c=32, interpret=True, corpus_resident=True)
    return np.asarray(vals)[:M], np.asarray(idx)[:M]


def _case(name):
    """(queries, corpus, banned, k): each made to break a part of the scan."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "ties_across_tiles_and_slabs":
        # blocks of equal rows straddling rows 127|128, 255|256 (tile and,
        # with 3 slabs, slab boundaries) and the end of the corpus
        base = (rng.random((6, 128)) < 0.1).astype(np.int8)
        corpus = (rng.random((700, 128)) < 0.1).astype(np.int8)
        for j, start in enumerate((120, 250, 380, 505, 640, 690)):
            corpus[start:start + 10] = base[j]
        queries = base[[0, 1, 2, 3, 4, 5, 1, 2]].copy()
        queries[6:, :3] ^= 1
        return queries, corpus, None, 20
    if name == "ties_at_the_kth_place":
        # 7 rows at distance 0 and 30 at the next distance, spread over
        # tiles: k = 20 cuts through the tie, lowest indices first
        corpus = rng.integers(20, 40, (600, 64)).astype(np.int8)
        query = np.zeros((1, 64), np.int8)
        corpus[rng.choice(600, 7, replace=False)] = 0
        near = np.zeros(64, np.int8)
        near[5] = 1
        corpus[rng.choice(np.arange(600), 30, replace=False)] = near
        return np.repeat(query, 3, axis=0), corpus, None, 20
    if name == "everything_banned":
        corpus = rng.integers(-3, 4, (3, 32)).astype(np.int8)
        banned = np.array([[0, 1, 2], [2, 1, 0], [0, -1, 5]], np.int32)
        return corpus.copy(), corpus, banned, 5
    if name == "fewer_rows_than_k":
        corpus = rng.integers(-5, 6, (9, 48)).astype(np.int8)
        return rng.integers(-5, 6, (4, 48)).astype(np.int8), corpus, None, 20
    if name == "banned_ties_ragged":
        corpus = (rng.random((333, 96)) < 0.2).astype(np.int8)
        corpus[rng.integers(0, 333, 150)] = corpus[rng.integers(0, 333, 150)]
        queries = corpus[rng.integers(0, 333, 37)].copy()
        banned = rng.integers(-1, 333, (37, 3)).astype(np.int32)
        return queries, corpus, banned, 9
    if name.startswith("runs_ties_banned_k"):
        # k past INSERT_K: the first tiles send all 128 columns of a row
        # down the rare path (four runs), groups of equal rows straddle the
        # tile and slab boundaries and the k-th place, and banned ids fall
        # inside the groups
        k = int(name.rsplit("k", 1)[1])
        n = 2 * k + 200
        corpus = (rng.random((n, 64)) < 0.15).astype(np.int8)
        base = (rng.random((4, 64)) < 0.15).astype(np.int8)
        for j, start in enumerate((100, k - 40, n // 2, n - 90)):
            corpus[start:start + 70] = base[j]
        queries = np.concatenate([base, corpus[rng.integers(0, n, 3)]])
        queries[5, :2] ^= 1
        banned = rng.integers(-1, n, (len(queries), 2)).astype(np.int32)
        banned[:4, 0] = (130, k - 10, n // 2 + 5, n - 60)
        return queries, corpus, banned, k
    raise KeyError(name)


CASES = ["ties_across_tiles_and_slabs", "ties_at_the_kth_place",
         "everything_banned", "fewer_rows_than_k", "banned_ties_ragged",
         "runs_ties_banned_k129", "runs_ties_banned_k256",
         "runs_ties_banned_k512"]


@pytest.mark.parametrize("slabs", [1, 3])
@pytest.mark.parametrize("case", CASES)
def test_scan_statement_equals_pallas_kernel_and_oracle(case, slabs):
    queries, corpus, banned, k = _case(case)
    norms = topk.corpus_norms_padded(corpus, len(corpus))
    vals, idx, rare = scan_statement(queries, corpus, norms, banned, k,
                                     slabs)
    ref_v, ref_i = _jax(queries, corpus, banned, k)
    np.testing.assert_array_equal(idx, ref_i)
    np.testing.assert_array_equal(vals, ref_v)
    nb = 0 if banned is None else banned.shape[1]
    if len(corpus) >= k + nb:
        o_v, o_i = topk.numpy_reference_topk(queries, corpus, k, banned)
        np.testing.assert_array_equal(idx, o_i)
        np.testing.assert_array_equal(vals, o_v)
    assert rare > 0


def test_scan_statement_skips_padding_rows_and_walks_few_rare_paths():
    """Padding rows (norm BIG, as FlatIndex never makes them but a caller
    may) never enter, even where their score would beat the k-th; and after
    the first tiles of a slab the hot test sends almost no row to the rare
    path."""
    rng = np.random.default_rng(4)
    corpus = (rng.random((2000, 64)) < 0.1).astype(np.int8)
    queries = corpus[rng.integers(0, 1500, 16)].copy()
    norms = topk.corpus_norms_padded(corpus, 1500)   # rows 1500.. padding
    vals, idx, rare = scan_statement(queries, corpus, norms, None, 5, 1)
    o_v, o_i = topk.numpy_reference_topk(queries, corpus[:1500], 5)
    np.testing.assert_array_equal(idx, o_i)
    np.testing.assert_array_equal(vals, o_v)
    tiles = -(-2000 // topk.TILE_C)
    assert rare < 0.5 * tiles * len(queries)


@pytest.mark.parametrize("m,n", [(1, 1), (5, 129), (128, 128), (129, 3001),
                                 (300, 50_000), (8192, 200_000),
                                 (8192, 700_000)])
@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("tile_q", [topk.TILE_Q, topk.TILE_Q_LARGE_K])
def test_plan_covers_every_tile_pair_once(m, n, sms, tile_q):
    """The work items of the persistent blocks cover every (query tile,
    corpus tile) once, for items of 128 queries (k <= INSERT_K) and of 64
    (past it); a block's items differ in number from another's by at most
    one; no slab starts past the corpus unless it is empty."""
    slabs = topk.slab_count(m, n, sms, tile_q)
    assert 1 <= slabs <= -(-n // topk.TILE_C)
    plan = scan_plan(m, n, slabs, sms, tile_q)
    assert len(plan) == min(sms, -(-m // tile_q) * slabs)
    counts = [len(items) for items in plan]
    assert max(counts) - min(counts) <= 1
    seen = np.zeros((-(-m // tile_q), -(-n // topk.TILE_C)), np.int64)
    for items in plan:
        for qt, slab, begin, end in items:
            assert begin <= end <= n
            assert begin % topk.TILE_C == 0 or begin == end == n  # empty
            for c0 in range(begin, end, topk.TILE_C):
                seen[qt, c0 // topk.TILE_C] += 1
    assert (seen == 1).all()


def test_scan_layout_fits_every_k():
    """The scan's plan (topk.scan_layout, the Python statement of
    csrc/exact_topk.cu::scan_plan, which the card tests hold to the
    library's) for every k the kernels take: the block's shared memory
    within the 232,448 bytes a block may use, a ring of 2-4 stages, as deep
    as fits; up to INSERT_K items of 128 queries with their lists in shared
    memory, as before the large-k route was redesigned (four stages at
    k = 20, three at 128); past it items of 64, their lists in shared
    memory up to the largest k whose 64 lists fit beside two stages, and in
    device memory from there on beside four."""
    run_bytes = 4 * 8 * topk.RUN * 8
    shared = []
    for k in range(1, topk.MAX_K + 1):
        plan = topk.scan_layout(k)
        large = k > topk.INSERT_K
        stage = (plan.queries + topk.TILE_C) * topk.CHUNK
        lists = plan.queries * k * 8
        fixed = topk.ALIGN + 2 * topk.MAX_STAGES * 8 + (run_bytes if large
                                                        else 0)
        assert plan.queries == (topk.TILE_Q_LARGE_K if large else topk.TILE_Q)
        assert 2 <= plan.stages <= topk.MAX_STAGES
        assert plan.shared_bytes == (fixed + plan.stages * stage
                                     + (0 if plan.device_lists else lists))
        assert plan.shared_bytes <= topk.SMEM_LIMIT == 232448
        assert (plan.stages == topk.MAX_STAGES
                or plan.shared_bytes + stage > topk.SMEM_LIMIT)
        assert plan.device_lists == (fixed + 2 * stage + lists
                                     > topk.SMEM_LIMIT)
        if not plan.device_lists:
            shared.append(k)
    assert shared == list(range(1, 340))
    assert topk.scan_layout(20).stages == 4
    assert topk.scan_layout(128).stages == 3
    assert topk.scan_layout(256) == (64, 3, 214080, False)
    assert topk.scan_layout(340) == (64, 4, 107584, True)
    with pytest.raises(ValueError, match=f"1..{topk.MAX_K}"):
        topk.scan_layout(topk.MAX_K + 1)


@pytest.mark.parametrize("n,d,nb", [(200_000, 1024, 1), (700_000, 2048, 1),
                                    (700_000, 2048, 3), (1000, 16, 1)])
@pytest.mark.parametrize("k", [20, 128])
def test_search_chunks_hold_the_budget(n, d, nb, k, monkeypatch):
    """The query chunk FlatIndex takes on a card of 132 multiprocessors keeps
    queries, banned ids, results and the slabs' partial lists within the
    search budget, and takes all 8192 queries at once at k = 20."""
    from textreact_tpu_torch.retrieval import engine
    monkeypatch.setattr(engine, "split_slabs",
                        lambda m, rows, device: topk.slab_count(m, rows, 132))

    class Card:
        corpus = torch.empty((n, 0), dtype=torch.int8)
        dim = d
        device = torch.device("cuda")

    m = FlatIndex.max_queries(Card(), k, nb)
    slabs = topk.slab_count(m, n, 132)
    need = m * (d + 4 * nb + 8 * k) + topk.workspace_bytes(m, k, slabs)
    assert need <= SEARCH_BUDGET_BYTES
    if k == 20:
        assert m >= 8192


def test_search_refuses_k_beyond_the_kernels():
    """Any k >= 1 on the CPU, as the JAX package takes; on the card a k
    past the kernels' MAX_K is refused before any device work."""
    index = FlatIndex(np.zeros((4, 16), np.int8), device="cpu")
    with pytest.raises(ValueError, match=f"1..{topk.MAX_K}"):
        index.search(np.zeros((2, 16), np.int8), k=0)
    for k in (topk.MAX_K, topk.MAX_K + 1):
        vals, idx = index.search(np.zeros((2, 16), np.int8), k=k)
        assert vals.shape == idx.shape == (2, k)
        assert (idx[:, 4:] == topk.BIG).all()
    index.device = torch.device("cuda")
    with pytest.raises(ValueError, match=f"1..{topk.MAX_K}"):
        index.search(np.zeros((2, 16), np.int8), k=topk.MAX_K + 1)


def test_retrieval_cli_refuses_k_beyond_the_kernels(tmp_path, capsys):
    from textreact_tpu_torch.retrieval import cli
    files = ["--data_path", str(tmp_path), "--train_file", "x.csv",
             "--valid_file", "x.csv", "--test_file", "x.csv",
             "--output_path", str(tmp_path / "out")]
    for extra in (["--k", str(topk.MAX_K + 1)],           # the card
                  ["--k", "0", "--device", "cpu"]):
        with pytest.raises(SystemExit):
            cli.main(files + extra)
        assert f"1..{topk.MAX_K}" in capsys.readouterr().err
        assert not (tmp_path / "out").exists()
    args = cli.get_args(files + ["--k", str(topk.MAX_K + 1), "--device",
                                 "cpu"])
    assert args.k == topk.MAX_K + 1
