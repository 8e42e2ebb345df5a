"""Host data loader: deterministic shuffling + background batch assembly
(twin of textreact_tpu/data/loader.py; its one use of the accelerator
runtime, the fork guard, asks CUDA instead).

Replaces the reference's torch DataLoader with 8 worker processes
(reference main.py:325-328). Examples are assembled on the host and
prefetched on a background thread so batch construction overlaps device
steps; per-example RNG is keyed by (seed, epoch, index) so any example is
reproducible in isolation (the role of Lightning's seed_everything(workers=
True), reference main.py:351).
"""

from __future__ import annotations

import queue
import random as _random
import threading
from typing import Iterator, List, Optional

from .collate import Batch, Collator


def example_rng(seed: int, epoch: int, index: int) -> _random.Random:
    # deterministic integer mixing (no salted string hashing)
    key = (seed * 1_000_003 + epoch) * 2_654_435_761 + index
    return _random.Random(key & 0xFFFFFFFFFFFF)


class DataLoader:
    def __init__(self, dataset, collator: Collator, batch_size: int,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = False,
                 fixed_shapes: bool = True, prefetch: int = 4,
                 augment: Optional[bool] = None, num_workers: int = 0):
        self.dataset = dataset
        self.collator = collator
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.fixed_shapes = fixed_shapes
        self.prefetch = prefetch
        self.augment = augment
        # >0: build+collate batches in forked worker processes (role of the
        # reference's torch DataLoader num_workers=8, main.py:325-328)
        self.num_workers = num_workers
        # multi-process (multi-host) data sharding: each process iterates a
        # disjoint stride of the index space (role of DistributedSampler)
        self.process_index = 0
        self.process_count = 1
        self.epoch = 0

    def shard_across_processes(self, process_index: int, process_count: int) -> "DataLoader":
        self.process_index = process_index
        self.process_count = process_count
        return self

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.process_count > 1:
            n = -(-n // self.process_count)  # padded per-process shard
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _order(self) -> List[int]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            # identical permutation on every process (same seed), then a
            # disjoint stride per process
            _random.Random(self.seed * 7_368_787 + self.epoch).shuffle(order)
        if self.process_count > 1:
            # pad to a multiple of process_count by wrapping around (the
            # reference's DistributedSampler semantics) so every process
            # yields the SAME number of batches per epoch — otherwise one
            # process would enter an extra step's collectives and hang
            total = -(-len(order) // self.process_count) * self.process_count
            order = order + order[: total - len(order)]
            order = order[self.process_index::self.process_count]
        return order

    def _build(self, batch_indices: List[int]) -> Batch:
        examples = [
            self.dataset.example(i, rng=example_rng(self.seed, self.epoch, i),
                                 augment=self.augment)
            for i in batch_indices
        ]
        fixed_batch = self.batch_size if self.fixed_shapes else None
        return self.collator(examples, fixed_batch=fixed_batch)

    def __iter__(self) -> Iterator[Batch]:
        order = self._order()
        chunks = [order[i:i + self.batch_size]
                  for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            chunks = [c for c in chunks if len(c) == self.batch_size]
        if self.num_workers > 1 and len(chunks) > 1:
            yield from self._iter_multiprocess(chunks)
            return
        if self.prefetch <= 0:
            for c in chunks:
                yield self._build(c)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        err: List[BaseException] = []

        def worker():
            try:
                for c in chunks:
                    q.put(self._build(c))
            except BaseException as e:  # surfaced in the consumer
                err.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()
        if err:
            raise err[0]

    def _iter_multiprocess(self, chunks) -> Iterator[Batch]:
        """Fork-based parallel batch assembly. Workers inherit the dataset
        via fork (no per-task pickling of the DataFrame); each task builds
        and collates one batch; results stream back in order."""
        import multiprocessing as mp

        # forking after the CUDA runtime initializes is unsafe (a forked
        # child cannot use the parent's context, and device threads and
        # locks do not survive fork); this mode is for OFFLINE batch
        # assembly. A process that has only used the CPU is exempt.
        import torch
        if torch.cuda.is_initialized():
            raise RuntimeError(
                "DataLoader(num_workers>1) forks worker processes, which "
                "is unsafe after the CUDA runtime has initialized; use "
                "num_workers=0 (threaded prefetch) for on-device training "
                "or assemble batches offline.")
        ctx = mp.get_context("fork")
        with ctx.Pool(self.num_workers, initializer=_worker_init,
                      initargs=(self,)) as pool:
            for batch in pool.imap(_worker_build,
                                   [(self.epoch, c) for c in chunks],
                                   chunksize=1):
                yield batch


_WORKER_LOADER: Optional["DataLoader"] = None


def _worker_init(loader: "DataLoader") -> None:
    global _WORKER_LOADER
    _WORKER_LOADER = loader


def _worker_build(task) -> Batch:
    epoch, chunk = task
    loader = _WORKER_LOADER
    loader.epoch = epoch
    return loader._build(chunk)
