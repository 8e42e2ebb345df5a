"""Exact L2 nearest-neighbour search over int8 fingerprints, FAISS-flat
parity (twin of textreact_tpu/ops/topk.py).

`exact_topk_l2` returns, per query, the k smallest squared L2 distances to
the corpus rows and their indices, ordered by (distance, index): of two
equal distances the lower corpus index comes first. The arithmetic is
integer throughout (int8 products summed in int32), so the result is bit
for bit that of a brute-force scan. Corpus rows whose norm is >= `BIG`
(padding) and the per-query `banned` ids never enter; slots that no row
filled come back as (`BIG` + |q|^2, `BIG`).

On CUDA tensors the wrapper launches the hand-written kernels of
csrc/exact_topk.cu or raises; on CPU tensors it runs the plain version
below. Both layouts run one persistent scan (wgmma products from shared
memory that TMA fills, the selection on the accumulators in registers) over
work items of (query tile, corpus slab), a block an SM walking items
blockIdx, blockIdx + grid, ... `corpus_resident=False` is the query-outer
layout: one slab, the whole corpus, per query tile. `corpus_resident=True`
stands for the TPU kernel's corpus-resident grid: the corpus is cut into
slabs, each item keeps a partial list, and a second kernel merges the slabs'
lists per query. `LAUNCHES` counts the launches of each.

k: any k >= 1 on the CPU. On the card 1 <= k <= `MAX_K`: up to
`SHARED_LIST_K` the scan keeps its 128 sorted lists in shared memory; above,
in a device-memory workspace the wrapper allocates (the large-k route,
counted in `LARGE_K_LAUNCHES`), with the same order, ties and banned ids.

`numpy_reference_topk` is the host oracle (a float64 BLAS scan, exact for
these integers).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

BIG = 2**30  # distance and index of a slot that no corpus row filled
MAX_K = 1024  # kMaxK in the .cu: the card's largest k
SHARED_LIST_K = 128  # kMaxSharedK: up to here the lists are in shared memory
TILE_Q = 128  # queries a work item: two warpgroups of 64 (kTileQ in the .cu)
TILE_C = 128  # corpus rows a tile, the wgmma's N (kTileC): slabs are whole tiles
# corpus-split: work items to aim for, per multiprocessor (one persistent
# block an SM walks them). One: every slab restarts its lists from empty,
# and a list that has seen n columns still takes a new one with a
# probability of about k / n, so short slabs send many more tiles down the
# rare path. `chip_profile.py --path retrieval` on an H100 at 8192 queries,
# k = 20: 1, 2 and 4 items an SM took 5.49, 6.57 and 7.16 ms at N = 200,000
# x 1024 and 23.56, 25.53 and 26.84 ms at N = 700,000 x 2048
ITEMS_PER_SM = 1
LAUNCHES = {"query_outer": 0, "corpus_split": 0}
LARGE_K_LAUNCHES = {"query_outer": 0, "corpus_split": 0}  # k > SHARED_LIST_K

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "tr_topk_query_outer": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P],
    "tr_topk_corpus_split": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                             _I, _I, _P],
    "tr_topk_scan_shared": [_I, ctypes.POINTER(_I)],
}


def load_kernel():
    """Build (at first use) and load the kernels' library."""
    return _build.load("exact_topk", _SIGNATURES)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_slabs(m: int, n: int, device: torch.device) -> int:
    """How many slabs the corpus-split layout cuts `n` corpus rows into for
    `m` queries: about ITEMS_PER_SM work items (query tiles x slabs) for
    each multiprocessor, never more slabs than the corpus has tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return slab_count(m, n, sms)


def slab_count(m: int, n: int, sms: int) -> int:
    """`split_slabs` for a card of `sms` multiprocessors."""
    q_tiles = _cdiv(max(m, 1), TILE_Q)
    return max(1, min(ITEMS_PER_SM * sms // q_tiles, _cdiv(n, TILE_C)))


def scan_shared(k: int) -> Tuple[int, int]:
    """(stages of the scan's ring, bytes of dynamic shared memory a block
    takes) for k, as the library computes them for its launches: a ring of
    2-4 stages of 128 queries and 128 corpus rows x 128 bytes beside 128
    sorted lists of k keys (above SHARED_LIST_K the lists are in device
    memory and the ring has 4 stages)."""
    stages = _I(0)
    lib = load_kernel()
    nbytes = lib.tr_topk_scan_shared(k, ctypes.byref(stages))
    if nbytes < 0:
        raise ValueError(f"exact_topk_l2: k={k} outside 1..{MAX_K}")
    return stages.value, nbytes


def workspace_bytes(m: int, k: int, slabs: int) -> int:
    """Device memory the corpus-split layout needs for its partial lists."""
    return slabs * m * k * 8


def list_workspace_bytes(k: int, device: torch.device) -> int:
    """Device memory of the scan's lists on `device`: 128 lists of k keys
    for each multiprocessor (a block an SM) above SHARED_LIST_K, on a card."""
    if k <= SHARED_LIST_K or device.type != "cuda":
        return 0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * TILE_Q * k * 8


@contextlib.contextmanager
def _full_float32():
    """float32 products in full precision on the card (TF32 keeps ten bits
    of mantissa and would not be exact)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _abs_max(x: torch.Tensor) -> int:
    return max(-int(x.min()), int(x.max())) if x.numel() else 0


def exact_topk_l2_reference(queries: torch.Tensor, corpus: torch.Tensor,
                            corpus_norms: torch.Tensor,
                            banned: Optional[torch.Tensor] = None, *,
                            k: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernels: the whole (query chunk, N) distance
    matrix by a matrix product, banned and padding columns set to `BIG`, a
    stable sort (ties keep the lower index) and its first k.

    The product must be exact: float32 is, while d * max|q| * max|c| < 2^24
    (every partial sum is then an integer that float32 holds), with TF32
    off; beyond that the product runs in float64."""
    M, d = queries.shape
    N = corpus.shape[0]
    dev = queries.device
    exact32 = d * _abs_max(queries) * _abs_max(corpus) < 2 ** 24
    ftype = torch.float32 if exact32 else torch.float64
    norms = corpus_norms.to(torch.int64)
    padding = (norms >= BIG)[None, :]
    vals = torch.full((M, k), BIG, dtype=torch.int64, device=dev)
    idx = torch.full((M, k), BIG, dtype=torch.int64, device=dev)
    chunk = max(1, min(M, (1 << 27) // max(N, 1)))  # distances: <= 1 GiB
    slab = 65536
    with _full_float32():
        for m0 in range(0, M, chunk):
            q = queries[m0:m0 + chunk]
            qf = q.to(ftype)
            dist = torch.empty((q.shape[0], N), dtype=torch.int64, device=dev)
            for n0 in range(0, N, slab):
                dots = qf @ corpus[n0:n0 + slab].to(ftype).T
                dist[:, n0:n0 + slab] = (norms[None, n0:n0 + slab]
                                         - 2 * dots.to(torch.int64))
            dist.masked_fill_(padding, BIG)
            if banned is not None:
                b = banned[m0:m0 + chunk].to(torch.int64)
                rows = torch.arange(q.shape[0], device=dev)[:, None]
                ok = (b >= 0) & (b < N)
                dist[rows.expand_as(b)[ok], b[ok]] = BIG
            v, i = torch.sort(dist, dim=1, stable=True)
            v, i = v[:, :k], i[:, :k]
            kk = v.shape[1]  # N when the corpus has fewer than k rows
            idx[m0:m0 + chunk, :kk] = torch.where(v >= BIG, BIG, i)
            vals[m0:m0 + chunk, :kk] = v
    qnorm = (queries.to(torch.int64) ** 2).sum(1, keepdim=True)
    return (vals + qnorm).to(torch.int32), idx.to(torch.int32)


def exact_topk_l2(queries: torch.Tensor, corpus: torch.Tensor,
                  corpus_norms: torch.Tensor,
                  banned: Optional[torch.Tensor] = None, *, k: int = 20,
                  corpus_resident: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k smallest L2^2 distances.

    queries: (M, d) int8, corpus: (N, d) int8, any M and N >= 1;
    corpus_norms: (N,) int32 with >= BIG marking padding rows; banned:
    (M, NB) int32 corpus indices excluded per query (-1 for none).
    |values| <= 127 and d <= 2048 keep every score inside int32.

    Returns (distances (M, k) int32 INCLUDING |q|^2, indices (M, k) int32),
    on the inputs' device. On the card the kernel runs on that device's
    current stream, whichever device is current (an index sharded over
    several cards calls it for each)."""
    if not queries.is_cuda:
        if k < 1:
            raise ValueError(f"exact_topk_l2: k={k} < 1")
        return exact_topk_l2_reference(queries, corpus, corpus_norms, banned,
                                       k=k)
    with torch.cuda.device(queries.device):
        return _exact_topk_l2_cuda(queries, corpus, corpus_norms, banned, k,
                                   corpus_resident)


def _exact_topk_l2_cuda(queries, corpus, corpus_norms, banned, k: int,
                        corpus_resident: bool):
    M, d = queries.shape
    N = corpus.shape[0]
    if banned is None:
        banned = torch.full((M, 1), -1, dtype=torch.int32,
                            device=queries.device)
    _check(queries, corpus, corpus_norms, banned, k)
    if d % 16:
        # the kernel copies 16 bytes at a time; zero columns change no
        # distance (FlatIndex pads its corpus once, so this copy is rare)
        queries = F.pad(queries, (0, 16 - d % 16))
        corpus = F.pad(corpus, (0, 16 - d % 16))
        d = queries.shape[1]
    vals = torch.empty((M, k), dtype=torch.int32, device=queries.device)
    idx = torch.empty_like(vals)
    if M == 0:
        return vals, idx
    lib = load_kernel()
    large = k > SHARED_LIST_K
    lists = None
    if large:
        lists = torch.empty(list_workspace_bytes(k, queries.device) // 8,
                            dtype=torch.int64, device=queries.device)
    counts = LARGE_K_LAUNCHES if large else LAUNCHES
    head = (_build.ptr(queries), _build.ptr(corpus), _build.ptr(corpus_norms),
            _build.ptr(banned))
    tail = (_build.ptr(lists), M, N, d, banned.shape[1], k, _build.stream())
    if corpus_resident:
        slabs = split_slabs(M, N, queries.device)
        partial = torch.empty((slabs, M, k), dtype=torch.int64,
                              device=queries.device)
        err = lib.tr_topk_corpus_split(*head, _build.ptr(partial), slabs,
                                       _build.ptr(vals), _build.ptr(idx),
                                       *tail)
        _build.check(lib, err, "exact_topk_l2 (corpus split)")
        counts["corpus_split"] += 1
    else:
        err = lib.tr_topk_query_outer(*head, _build.ptr(vals), _build.ptr(idx),
                                      *tail)
        _build.check(lib, err, "exact_topk_l2 (query outer)")
        counts["query_outer"] += 1
    return vals, idx


def _check(queries, corpus, corpus_norms, banned, k: int) -> None:
    """Validate the kernels' preconditions."""
    M, d = queries.shape
    N = corpus.shape[0]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"exact_topk_l2: k={k} outside 1..{MAX_K}")
    if corpus.dim() != 2 or corpus.shape[1] != d or N < 1 or d < 1:
        raise ValueError(f"exact_topk_l2: queries {tuple(queries.shape)} vs "
                         f"corpus {tuple(corpus.shape)}")
    if corpus_norms.shape != (N,):
        raise ValueError(f"exact_topk_l2: corpus_norms "
                         f"{tuple(corpus_norms.shape)}, expected ({N},)")
    if banned.dim() != 2 or banned.shape[0] != M or banned.shape[1] < 1:
        raise ValueError(f"exact_topk_l2: banned {tuple(banned.shape)}, "
                         f"expected ({M}, NB >= 1)")
    for name, t, dtype in (("queries", queries, torch.int8),
                           ("corpus", corpus, torch.int8),
                           ("corpus_norms", corpus_norms, torch.int32),
                           ("banned", banned, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"exact_topk_l2: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if not t.is_cuda or t.device != queries.device:
            raise ValueError(f"exact_topk_l2: {name} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError(f"exact_topk_l2: {name} must be contiguous and "
                             f"16-byte aligned")


def pad_matrix(x: np.ndarray, row_multiple: int, col_multiple: int = 128
               ) -> np.ndarray:
    """Zero-pad rows/cols up to multiples."""
    r = _cdiv(x.shape[0], row_multiple) * row_multiple
    c = _cdiv(x.shape[1], col_multiple) * col_multiple
    if (r, c) == x.shape:
        return x
    out = np.zeros((r, c), dtype=x.dtype)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def corpus_norms_padded(corpus: np.ndarray, n_real: int) -> np.ndarray:
    """int32 squared norms with the BIG sentinel on padding rows."""
    norms = (corpus.astype(np.int64) ** 2).sum(axis=1).astype(np.int32)
    norms[n_real:] = np.int32(BIG)
    return norms


def numpy_reference_topk(queries: np.ndarray, corpus: np.ndarray, k: int,
                         banned: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Brute-force faiss-flat semantics: ascending distance, ties by lower
    index (the parity oracle for the kernels).

    The product runs in float64 BLAS rather than numpy's loop-based integer
    matmul: every product of int8 entries summed over d <= 2^13 stays below
    127 * 127 * 2^13 < 2^27 << 2^53, so float64 accumulation is bit-exact
    and the int64 cast below is lossless. The corpus is processed in slabs
    so that the float64 and int64 temporaries stay bounded."""
    q64 = queries.astype(np.float64)
    qq = (queries.astype(np.int64) ** 2).sum(1)
    n = corpus.shape[0]
    d2 = np.empty((queries.shape[0], n), np.int64)
    slab = 500_000
    for i in range(0, n, slab):
        j = min(i + slab, n)
        c = corpus[i:j]
        dot = (q64 @ c.astype(np.float64).T).astype(np.int64)
        cc = (c.astype(np.int64) ** 2).sum(1)
        d2[:, i:j] = qq[:, None] - 2 * dot + cc[None, :]
    if banned is not None:
        for i in range(queries.shape[0]):
            for b in banned[i]:
                if 0 <= b < n:
                    d2[i, b] = np.iinfo(np.int32).max
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(d2, idx, axis=1).astype(np.int32),
            idx.astype(np.int32))
