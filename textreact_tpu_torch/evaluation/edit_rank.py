"""Template edit ranking: merge atom/bond probabilities into a ranked list
(twin of textreact_tpu/evaluation/edit_rank.py: `device_topk_edits` in
torch, on the device; `edits_from_topk` and `rank_edits`, the host halves,
copied as they are).

Parity target: reference textreact/utils.py:69-108 (get_id_template /
output2edit / combined_edit). Differences in representation only: the model
emits bond probabilities at explicit bond pairs (B, MB, n_b+1) rather than a
dense (A, A, n_b+1) grid, so the reference's "filter non-bonds" step
(utils.py:87) is already satisfied by construction; template class 0 (the
background) is still filtered here. The ranked output format matches:
[('a', atom_idx, template), ('b', (i, j), template), ...] with probabilities
descending.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

Edit = Tuple  # ('a', int, int) | ('b', (int, int), int)


def _desc_topk_last_index_first(x: torch.Tensor, k: int):
    """Descending top-k over the last axis with the HOST tie order: among
    equal values the LARGER flat index ranks first (the host path is
    np.argsort(kind='stable')[::-1], i.e. stable-ascending reversed).
    `torch.topk` promises no order among ties, so this sorts the reversed
    array stably in descending order (equal values keep their reversed
    order: the larger original index first) and maps the indices back, as
    edit_rank.py:24-32 does around lax.top_k."""
    n = x.shape[-1]
    vals, rev_idx = torch.sort(x.flip(-1), dim=-1, descending=True,
                               stable=True)
    k = min(k, n)
    return vals[..., :k], n - 1 - rev_idx[..., :k]


def device_topk_edits(atom_probs: torch.Tensor, bond_probs: torch.Tensor,
                      bond_row_valid: torch.Tensor, k: int):
    """On-device edit pre-ranking: top-k over the flattened atom/bond
    probabilities before the host merge, replacing the host argsort over
    B*A*n_a + B*MB*n_b of reference utils.py:79-108.

    atom_probs: (B, A, n_a+1) softmax probs with ignored entries zeroed —
      padded atom rows stay in the ranking at prob 0.0 (reference includes
      them, main.py:202-206); only template class 0 is excluded.
    bond_probs: (B, MB, n_b+1); bond_row_valid: (B, MB) bool/int marking
      real (non-padded) bond rows — padded rows are excluded entirely
      (the host path slices bond_probs[:nb_real]).

    Returns (atom_vals, atom_idx, bond_vals, bond_idx), each (B, <=k), on
    the probabilities' device. Masked-out candidates carry value -1 (probs
    are >= 0); the host-side edits_from_topk drops them.
    """
    B, A, na1 = atom_probs.shape
    a_flat = atom_probs.reshape(B, A * na1)
    a_col = torch.arange(A * na1, device=a_flat.device) % na1
    a_flat = torch.where(a_col == 0, -1.0, a_flat)
    atom_vals, atom_idx = _desc_topk_last_index_first(a_flat, k)

    B, MB, nb1 = bond_probs.shape
    b_flat = bond_probs.reshape(B, MB * nb1)
    b_col = torch.arange(MB * nb1, device=b_flat.device) % nb1
    b_row_ok = bond_row_valid.bool().repeat_interleave(nb1, dim=1)
    b_flat = torch.where((b_col == 0) | ~b_row_ok, -1.0, b_flat)
    bond_vals, bond_idx = _desc_topk_last_index_first(b_flat, k)
    return atom_vals, atom_idx, bond_vals, bond_idx


def edits_from_topk(atom_vals: np.ndarray, atom_idx: np.ndarray,
                    bond_vals: np.ndarray, bond_idx: np.ndarray,
                    n_a1: int, n_b1: int,
                    bond_pairs: Sequence[Tuple[int, int]],
                    top_num: Optional[int] = None
                    ) -> Tuple[List[Edit], List[float]]:
    """Host half of the device ranking for ONE example: convert the top-k
    (value, flat-index) pairs back to edit tuples and merge exactly as
    rank_edits does (reference utils.py:96-108). O(k), not O(A*n_a)."""
    atom_edits, atom_probs_out = [], []
    for v, r in zip(np.asarray(atom_vals), np.asarray(atom_idx)):
        if v < 0:
            break  # masked candidates (template 0) sort last
        atom_edits.append(("a", int(r // n_a1), int(r % n_a1)))
        atom_probs_out.append(float(v))
        if top_num is not None and len(atom_edits) == top_num:
            break
    bond_edits, bond_probs_out = [], []
    for v, r in zip(np.asarray(bond_vals), np.asarray(bond_idx)):
        if v < 0:
            break
        pair = bond_pairs[int(r // n_b1)]
        bond_edits.append(("b", (int(pair[0]), int(pair[1])), int(r % n_b1)))
        bond_probs_out.append(float(v))
        if top_num is not None and len(bond_edits) == top_num:
            break

    all_edits = atom_edits + bond_edits
    all_probs = atom_probs_out + bond_probs_out
    merge = np.argsort(np.asarray(all_probs), kind="stable")[::-1]
    if top_num is not None:
        merge = merge[:top_num]
    return [all_edits[r] for r in merge], [all_probs[r] for r in merge]


def rank_edits(atom_probs: np.ndarray, bond_probs: np.ndarray,
               bond_pairs: Sequence[Tuple[int, int]],
               top_num: Optional[int] = None) -> Tuple[List[Edit], List[float]]:
    """atom_probs: (A, n_a+1) with padded/ignored entries zeroed;
    bond_probs: (MB, n_b+1) likewise; bond_pairs: MB (i, j) tuples."""
    edits: List[Edit] = []
    probs: List[float] = []

    # atom edits, template 0 excluded (utils.py:87-88)
    a_flat = atom_probs.reshape(-1)
    order = np.argsort(a_flat, kind="stable")[::-1]
    n_a = atom_probs.shape[1]
    atom_edits, atom_probs_out = [], []
    for r in order:
        template = int(r % n_a)
        if template == 0:
            continue
        atom_edits.append(("a", int(r // n_a), template))
        atom_probs_out.append(float(a_flat[r]))
        if top_num is not None and len(atom_edits) == top_num:
            break

    n_b = bond_probs.shape[1]
    nb_real = len(bond_pairs)
    b_flat = bond_probs[:nb_real].reshape(-1)
    order = np.argsort(b_flat, kind="stable")[::-1]
    bond_edits, bond_probs_out = [], []
    for r in order:
        template = int(r % n_b)
        if template == 0:
            continue
        pair = bond_pairs[int(r // n_b)]
        bond_edits.append(("b", (int(pair[0]), int(pair[1])), template))
        bond_probs_out.append(float(b_flat[r]))
        if top_num is not None and len(bond_edits) == top_num:
            break

    # merged rank (utils.py:96-108)
    all_edits = atom_edits + bond_edits
    all_probs = atom_probs_out + bond_probs_out
    merge = np.argsort(np.asarray(all_probs), kind="stable")[::-1]
    if top_num is not None:
        merge = merge[:top_num]
    return [all_edits[r] for r in merge], [all_probs[r] for r in merge]
