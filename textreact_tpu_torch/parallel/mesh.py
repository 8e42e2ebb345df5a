"""The (dp, tp) process mesh (twin of textreact_tpu/parallel/mesh.py).

One process drives one device. The world's ranks form a (dp, tp) grid,
tp neighbours adjacent: rank = dp_index * tp_size + tp_index, the order in
which the JAX package reshapes its device list. Each rank belongs to one
tensor-parallel group (the tp_size ranks of its row) and one data-parallel
group (the dp_size ranks of its column).

What replaces the JAX package's two shardings:
- `batch_sharding` (the leading axis over 'dp', replicated over 'tp'): each
  rank loads the rows of its dp index only (`DataLoader.shard_across_processes
  (mesh.dp_rank, mesh.dp_size)`), and the tp_size ranks of a row load the
  same rows, so a batch is replicated over tp;
- `replicated`: a tensor that every rank holds whole, which is every tensor
  that `shard_params` does not split.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch.distributed as dist

DP_AXIS = "dp"
TP_AXIS = "tp"


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (dp, tp) grid, its two process groups and
    the group of the whole grid (None where torch.distributed is not
    initialised: one process, no collective runs)."""
    dp_size: int
    tp_size: int
    dp_rank: int
    tp_rank: int
    dp_group: Optional[object] = None
    tp_group: Optional[object] = None
    dp_ranks: List[int] = dataclasses.field(default_factory=lambda: [0])
    tp_ranks: List[int] = dataclasses.field(default_factory=lambda: [0])
    group: Optional[object] = None

    @property
    def shape(self):
        return {DP_AXIS: self.dp_size, TP_AXIS: self.tp_size}

    @property
    def distributed(self) -> bool:
        return self.dp_group is not None


def make_mesh(dp_size: int = -1, tp_size: int = 1) -> Optional[Mesh]:
    """The mesh over the first dp_size * tp_size ranks of the world.

    `dp_size=-1` takes every rank not on the tp axis (world // tp_size), as
    the JAX package does. Every rank of the world must call this (creating
    a process group is collective); a rank outside the grid gets None.
    Without torch.distributed the world is this one process."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dp_size == -1:
        assert world % tp_size == 0, (world, tp_size)
        dp_size = world // tp_size
    assert dp_size >= 1 and tp_size >= 1, (dp_size, tp_size)
    assert dp_size * tp_size <= world, (dp_size, tp_size, world)
    if not dist.is_initialized():
        return Mesh(dp_size=1, tp_size=1, dp_rank=0, tp_rank=0)
    grid_group = dist.new_group(list(range(dp_size * tp_size)))
    mine = None
    for d in range(dp_size):       # tp groups: one row of the grid each
        ranks = [d * tp_size + t for t in range(tp_size)]
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = dict(tp_group=group, tp_ranks=ranks, dp_rank=d,
                        tp_rank=ranks.index(rank))
    for t in range(tp_size):       # dp groups: one column each
        ranks = [d * tp_size + t for d in range(dp_size)]
        group = dist.new_group(ranks)
        if rank in ranks:
            mine.update(dp_group=group, dp_ranks=ranks)
    if mine is None:
        return None
    return Mesh(dp_size=dp_size, tp_size=tp_size, group=grid_group, **mine)


def local_batch_size(global_batch: int, mesh: Optional[Mesh]) -> int:
    """The rows one rank loads of a global batch."""
    dp = 1 if mesh is None else mesh.dp_size
    assert global_batch % dp == 0, (global_batch, dp)
    return global_batch // dp
