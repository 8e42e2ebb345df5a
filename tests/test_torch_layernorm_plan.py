"""The residual-LN wrapper's launch planner, in Python on the CPU.

The kernels (csrc/fused_layernorm.cu) run only on the card; what the
wrapper decides around them is plain Python: the backward's grid
(`grid_blocks`, from the library's occupancy plan) and how many of its
blocks sum the dscale / dbias workspace (`split_blocks`). These tests hold
those decisions to what the kernel assumes of them, and restate the
kernel's split of the workspace in Python to show that it sums every
element once.
"""

import _torch_threads  # noqa: F401  (before torch runs)
import numpy as np
import pytest

from textreact_tpu_torch.ops import fused_layernorm as fl

SMS = 132          # an H100's SMs
THREADS = 256      # a backward block (kBwdThreads in the .cu)


def _plan(rows_per_block, blocks_per_sm, sms=SMS):
    return fl.Plan(rows_per_block=rows_per_block,
                   blocks_per_sm=blocks_per_sm, sms=sms)


@pytest.mark.parametrize("rows,per_block,per_sm,want", [
    (0, 8, 2, 1),                 # a backward of no rows still runs
    (1, 8, 2, 1),
    (8, 8, 2, 1),
    (9, 8, 2, 2),
    (512, 8, 1, 64),              # the decoder's rows in training
    (2112, 8, 2, 264),            # exactly the card's resident rows
    (2113, 8, 2, 264),            # one more: a group walks a second row
    (16384, 8, 1, 132),
    (16384, 1, 4, 528),           # the wide route: a row a block
])
def test_grid_is_the_resident_blocks_or_fewer(rows, per_block, per_sm, want):
    assert fl.grid_blocks(rows, _plan(per_block, per_sm)) == want


def _split_counts(nblocks, hidden, split):
    """How often split_column_sums adds each (row, float4 column) of the
    (nblocks, 2 * hidden) workspace: its slices, runs and threads, as in
    the kernel."""
    cols4 = 2 * hidden // 4
    per = -(-cols4 // split)
    counts = np.zeros((nblocks, cols4), dtype=np.int64)
    for slice_ in range(split):
        c0 = slice_ * per
        ncol = min(per, cols4 - c0)
        if ncol <= 0:
            continue
        parts = max(1, min(THREADS // ncol, nblocks))
        run = -(-nblocks // parts)
        for k in range(ncol * parts):   # a (column, run) pair a thread
            col, p = k % ncol, k // ncol
            counts[p * run:min((p + 1) * run, nblocks), c0 + col] += 1
    return counts


@pytest.mark.parametrize("nblocks,hidden", [
    (1, 128), (2, 768), (3, 768), (64, 768), (132, 768), (264, 768),
    (133, 1024), (132, 2048), (528, 2048), (132, 8192), (4224, 8192)])
def test_split_sums_every_workspace_element_once(nblocks, hidden):
    split = fl.split_blocks(nblocks, hidden)
    assert 1 <= split <= max(1, nblocks // 2) and split <= fl.MAX_SPLIT
    assert (_split_counts(nblocks, hidden, split) == 1).all()


@pytest.mark.parametrize("nblocks", [1, 2, 3, 7, 264, 10_000])
def test_split_leaves_every_block_columns_to_sum(nblocks):
    """A slice holds at least four float4 columns, and no more blocks wait
    for the others than half the grid."""
    for hidden in (128, 768, 8192):
        split = fl.split_blocks(nblocks, hidden)
        assert 2 * hidden // 4 >= 4 * split or split == 1
        assert split == 1 or 2 * split <= nblocks
