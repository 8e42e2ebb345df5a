"""Exact nearest-neighbour engine (twin of textreact_tpu/retrieval/engine.py).

Role of reference retrieve/retrieve_faiss.py: build an exact L2 index over
fingerprint vectors and query top-20 neighbours.

- the corpus matrix and its norms are put on the device once, as int8 and
  int32; a search runs the fused distance + top-k kernels of ops/topk.py
  over it;
- masked retrieval (self/gold removal, reference dataset.py:74-76) is a
  per-query banned-id list applied inside the kernel, not a host-side
  filter;
- `merge_topk` merges partial results over parts of a corpus with a
  two-key order (distance, then corpus index) that preserves the faiss tie
  order;
- `FlatIndex(corpus, devices=[...])` cuts the corpus rows into one shard
  per listed device, as the JAX engine's single-controller `mesh` does
  (engine.py:48-121): one process queues every shard's upload, top-k
  kernel and download on its own device's stream, then waits for them,
  offsets each shard's indices and merges the lists with `merge_topk`; the
  shards on different cards run at once. A device may be listed twice
  (`["cuda:0", "cuda:0"]`, `["cpu", "cpu"]`), so the sharded path runs on
  one card and on the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.factory import resolve_device
from ..ops.topk import (BIG, MAX_K, corpus_norms_padded, exact_topk_l2,
                        numpy_reference_topk, pad_matrix, split_slabs,
                        workspace_bytes)

# Layout rule, measured on an H100 80GB HBM3 at 700 W by chip_smoke.py's
# retrieval phase at M = 8192, k = 20 (PERF.md, section 6): the
# corpus-split layout was faster at both shapes, 10.8 against 23.0 ms at
# N = 200,000 x 1024 and 56.0 against 130.6 ms at N = 700,000 x 2048 (its
# grid has several times the query-outer grid's M / 128 blocks, which alone
# do not fill the card's 132 multiprocessors).
# With so many queries that the query tiles fill the card, corpus-split runs
# with one slab and is the query-outer scan plus a copy. So the rule is that
# layout, always; corpus_resident=False overrides it.
CORPUS_RESIDENT_DEFAULT = True

# Device memory one kernel call may take for its queries, banned ids,
# partial lists and results: larger query sets are searched in chunks.
SEARCH_BUDGET_BYTES = 1 << 30


class FlatIndex:
    """Exact (flat) L2 index over int8 fingerprint vectors.

    `device=None` is the CUDA card and raises without one. `corpus_resident`
    picks the kernel layout (None: the measured rule above). `devices`, a
    list of devices, shards the corpus rows over them in order (shard s
    holds rows s * ceil(N / S) onward) instead of putting it on `device`."""

    def __init__(self, corpus_fps: np.ndarray, device=None,
                 corpus_resident: Optional[bool] = None,
                 devices: Optional[Sequence] = None):
        assert corpus_fps.dtype == np.int8, corpus_fps.dtype
        self.shards: List[Tuple[int, "FlatIndex"]] = []
        if devices is not None:
            self._shard(corpus_fps, list(devices), corpus_resident)
            return
        self.device = resolve_device(device)
        self.n_real = corpus_fps.shape[0]
        self.corpus_resident = (CORPUS_RESIDENT_DEFAULT
                                if corpus_resident is None
                                else corpus_resident)
        # columns to whole 16-byte pieces (zeros change no distance); an
        # empty corpus becomes one padding row, which never enters
        padded = pad_matrix(corpus_fps, 1, 16)
        if self.n_real == 0:
            padded = np.zeros((1, padded.shape[1]), np.int8)
        norms = corpus_norms_padded(padded, self.n_real)
        self.dim = padded.shape[1]
        self.corpus = torch.from_numpy(np.ascontiguousarray(padded)
                                       ).to(self.device)
        self.norms = torch.from_numpy(norms).to(self.device)

    def _shard(self, corpus_fps: np.ndarray, devices: List,
               corpus_resident: Optional[bool]) -> None:
        """One index over each shard of rows, with the shard's first row."""
        self.n_real = corpus_fps.shape[0]
        self.device = resolve_device(devices[0])
        rows = -(-self.n_real // len(devices))
        for s, dev in enumerate(devices):
            part = corpus_fps[s * rows:(s + 1) * rows]
            self.shards.append((s * rows, FlatIndex(
                part, device=dev, corpus_resident=corpus_resident)))
        self.dim = self.shards[0][1].dim
        self.corpus_resident = self.shards[0][1].corpus_resident

    def max_queries(self, k: int, nb: int) -> int:
        """Most queries one kernel call takes inside SEARCH_BUDGET_BYTES
        (of an unsharded index, or of one shard)."""
        n = self.corpus.shape[0]
        m = 1 << 16
        while m > 128:
            slabs = (split_slabs(m, n, self.device)
                     if self.device.type == "cuda" else 1)
            need = (m * (self.dim + 4 * nb + 8 * k)
                    + workspace_bytes(m, k, slabs))
            if need <= SEARCH_BUDGET_BYTES:
                break
            m //= 2
        return m

    def search(self, queries: np.ndarray, k: int = 20,
               banned: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k (distances, indices), faiss-flat semantics. `banned` is
        (M, NB) int32 global corpus ids to exclude per query (-1 = none).
        1 <= k <= MAX_K on every device: the kernels keep each query's list
        in shared memory, so a larger k is refused before any device work.

        On the card each chunk's queries and banned ids go up through pinned
        staging buffers and the results come back through pinned buffers,
        every copy asynchronous on the kernels' stream. A sharded index
        queues a chunk on every shard before it waits for any of them, then
        merges the shards' lists (banned ids made local to each shard, its
        results offset to global ids) in (distance, index) order."""
        if not 1 <= k <= MAX_K:
            raise ValueError(f"FlatIndex.search: k={k} outside 1..{MAX_K}: "
                             f"the top-k kernels keep each query's list in "
                             f"shared memory")
        assert queries.dtype == np.int8, queries.dtype
        M = queries.shape[0]
        q = pad_matrix(queries, 1, 16)
        assert q.shape[1] == self.dim, (q.shape, self.dim)
        nb = 1 if banned is None else banned.shape[1]
        parts = self.shards or [(0, self)]
        chunk = min([index.max_queries(k, nb) for _, index in parts]
                    + [max(M, 1)])
        stages = [_Staging(index.device, chunk, self.dim,
                           None if banned is None else nb, k)
                  for _, index in parts]
        out_v = np.empty((M, k), np.int32)
        out_i = np.empty((M, k), np.int32)
        for start in range(0, M, chunk):
            stop = min(start + chunk, M)
            chunk_banned = None if banned is None else banned[start:stop]
            for (first, index), stage in zip(parts, stages):
                local = chunk_banned
                if self.shards and banned is not None:
                    local = np.where(
                        (chunk_banned >= first)
                        & (chunk_banned < first + index.n_real),
                        chunk_banned - first, -1).astype(np.int32)
                index._launch(stage, q[start:stop], local, k)
            if not self.shards:
                out_v[start:stop], out_i[start:stop] = stages[0].collect()
                continue
            lists = []
            for (first, _), stage in zip(parts, stages):
                vals, idx = stage.collect()
                lists.append((torch.from_numpy(vals.copy()), torch.from_numpy(
                    np.where(idx >= BIG, idx, idx + first).astype(np.int32))))
            vals, idx = merge_topk(lists, k)
            out_v[start:stop], out_i[start:stop] = vals.numpy(), idx.numpy()
        return out_v, out_i

    def _launch(self, stage: "_Staging", q: np.ndarray,
                banned: Optional[np.ndarray], k: int) -> None:
        """Queue one chunk's upload, kernel and download on this index's
        device; `stage.collect()` waits for it."""
        q_dev, b_dev = stage.up(q, banned)
        vals, idx = exact_topk_l2(q_dev, self.corpus, self.norms, b_dev, k=k,
                                  corpus_resident=self.corpus_resident)
        stage.down(vals, idx)

    def reference_search(self, queries: np.ndarray, k: int = 20,
                         banned: Optional[np.ndarray] = None):
        """Brute-force numpy oracle over the same (unpadded) data."""
        if self.shards:
            corpus = np.concatenate([
                index.corpus[: index.n_real].cpu().numpy()
                for _, index in self.shards])
        else:
            corpus = self.corpus[: self.n_real].cpu().numpy()
        return numpy_reference_topk(pad_matrix(queries, 1, 16), corpus, k,
                                    banned)


class _Staging:
    """Host buffers of one search. On the card: pinned, reused chunk after
    chunk (each chunk's results are read before the next chunk's queries
    are written); on the CPU the arrays are used in place."""

    def __init__(self, device: torch.device, rows: int, dim: int,
                 nb: Optional[int], k: int):
        self.device = device
        self.pinned = device.type == "cuda"
        if self.pinned:
            self.q = torch.empty((rows, dim), dtype=torch.int8,
                                 pin_memory=True)
            self.b = (None if nb is None else
                      torch.empty((rows, nb), dtype=torch.int32,
                                  pin_memory=True))
            self.v = torch.empty((rows, k), dtype=torch.int32,
                                 pin_memory=True)
            self.i = torch.empty_like(self.v, pin_memory=True)

    def up(self, q: np.ndarray, banned: Optional[np.ndarray]):
        """(queries, banned ids) of one chunk on the device."""
        if not self.pinned:
            b = (None if banned is None else torch.from_numpy(
                np.ascontiguousarray(banned, dtype=np.int32)))
            return torch.from_numpy(np.ascontiguousarray(q)), b
        n = q.shape[0]
        self.q[:n].numpy()[...] = q
        q_dev = self.q[:n].to(self.device, non_blocking=True)
        b_dev = None
        if banned is not None:
            self.b[:n].numpy()[...] = banned
            b_dev = self.b[:n].to(self.device, non_blocking=True)
        return q_dev, b_dev

    def down(self, vals: torch.Tensor, idx: torch.Tensor) -> None:
        """Queue the copy of the chunk's results to the host."""
        if not self.pinned:
            self.result = (vals.numpy(), idx.numpy())
            return
        n = vals.shape[0]
        self.v[:n].copy_(vals, non_blocking=True)
        self.i[:n].copy_(idx, non_blocking=True)
        self.result = (self.v[:n], self.i[:n])

    def collect(self) -> Tuple[np.ndarray, np.ndarray]:
        """The queued results as numpy arrays, once the device is done
        (views of the staging buffers on the card: read them before the
        next chunk)."""
        if not self.pinned:
            return self.result
        torch.cuda.current_stream(self.device).synchronize()
        v, i = self.result
        return v.numpy(), i.numpy()


def merge_topk(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]], k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge partial top-k results over parts of a corpus: `parts` holds
    (distances (M, k_i), global indices (M, k_i)) per part; the lists are
    concatenated, ordered by (distance, index) and cut to k. Unfilled slots
    (index `BIG`) sort last."""
    vals = torch.cat([torch.as_tensor(v) for v, _ in parts], dim=1)
    idx = torch.cat([torch.as_tensor(i) for _, i in parts], dim=1)
    key = (vals.to(torch.int64) << 32) | idx.to(torch.int64)
    order = torch.sort(key, dim=1).indices[:, :k]
    return torch.gather(vals, 1, order), torch.gather(idx, 1, order)


def build_neighbor_file(ids: Sequence[str], train_ids: Sequence[str],
                        index: FlatIndex, query_fps: np.ndarray,
                        k: int = 20) -> List[Dict]:
    """{id, nn} records like retrieve_faiss.py:116-130 writes."""
    _, idx = index.search(query_fps, k=k)
    return [{"id": qid, "nn": [train_ids[j] for j in row if j < len(train_ids)]}
            for qid, row in zip(ids, idx.tolist())]
