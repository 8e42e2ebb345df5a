"""Beam search with a KV cache (twin of textreact_tpu/inference/beam.py).

HF semantics with length_penalty=0 and early_stopping=False, as in the JAX
package:
- scores are raw log-prob sums (no length normalisation);
- each step ranks the 2K best candidates; the best K that do not end in
  EOS stay live, and only EOS candidates ranked < K among the 2K enter the
  finished pool;
- search stops when no live beam can beat the worst finished score (a
  live score only decreases) or at max_length;
- finalize: live beams join the finished pool and the best K win.

Ties go to the lowest index, as `lax.top_k` gives them: selection sorts
with `torch.sort(stable=True)` (`torch.topk` promises no tie order).

Where the JAX package keeps its cache row-stable behind an ancestor bias
(a workaround for slow XLA gathers), the port reorders the self-attention
cache rows after each step (`reorder_fn`), HF's `_reorder_cache`. Each beam
attends over exactly its own history either way.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

NEG_INF = -1.0e7


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, best first, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (B, N, T), idx: (B, M) -> (B, M, T)."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def beam_search(step_fn: Callable[[torch.Tensor, int], torch.Tensor],
                reorder_fn: Callable[[torch.Tensor], None],
                batch_size: int, num_beams: int, max_length: int,
                bos_token_id: int, eos_token_id: int, pad_token_id: int,
                device=None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Returns (sequences (B, K, max_length), scores (B, K), steps run),
    best first.

    step_fn(tokens (B*K, 1), position) -> logits (B*K, 1, V) or (B*K, V);
    reorder_fn(rows (B*K,)) makes cache row r the old row rows[r]."""
    B, K, T = batch_size, num_beams, max_length
    live_seqs = torch.full((B, K, T), pad_token_id, dtype=torch.long,
                           device=device)
    live_seqs[:, :, 0] = bos_token_id
    # only beam 0 is a real hypothesis at the start
    live_scores = torch.full((B, K), NEG_INF, device=device)
    live_scores[:, 0] = 0.0
    fin_seqs = torch.full((B, K, T), pad_token_id, dtype=torch.long,
                          device=device)
    fin_scores = torch.full((B, K), NEG_INF, device=device)
    fin_flags = torch.zeros((B, K), dtype=torch.bool, device=device)
    rank = torch.arange(2 * K, device=device)[None, :]
    row_base = (torch.arange(B, device=device) * K)[:, None]

    def improvable() -> bool:
        worst_fin = torch.where(fin_flags, fin_scores, NEG_INF).amin(dim=1)
        best_live = live_scores.amax(dim=1)
        return bool(((best_live > worst_fin) | ~fin_flags.all(dim=1)).any())

    cur_len = 1
    while cur_len < T and improvable():
        logits = step_fn(live_seqs[:, :, cur_len - 1].reshape(B * K, 1),
                         cur_len - 1)
        V = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1).view(B, K, V)
        cand = (live_scores[:, :, None] + logp).view(B, K * V)
        topv, topi = top_k(cand, 2 * K)                     # (B, 2K)
        beam_idx = topi // V
        tok_idx = topi % V
        cand_seqs = _gather_rows(live_seqs, beam_idx)
        cand_seqs[:, :, cur_len] = tok_idx
        is_eos = tok_idx == eos_token_id

        # next live beams: the best K non-EOS candidates
        live_scores, live_sel = top_k(
            torch.where(is_eos, NEG_INF, topv), K)
        live_seqs = _gather_rows(cand_seqs, live_sel)
        parent = torch.gather(beam_idx, 1, live_sel)
        reorder_fn((parent + row_base).reshape(-1))

        # finished pool: EOS candidates ranked < K among the 2K
        eos_kept = is_eos & (rank < K)
        all_scores = torch.cat(
            [fin_scores, torch.where(eos_kept, topv, NEG_INF)], dim=1)
        all_flags = torch.cat([fin_flags, eos_kept], dim=1)
        all_seqs = torch.cat([fin_seqs, cand_seqs], dim=1)
        fin_scores, fin_sel = top_k(all_scores, K)
        fin_seqs = _gather_rows(all_seqs, fin_sel)
        fin_flags = torch.gather(all_flags, 1, fin_sel)
        cur_len += 1

    # HF finalize: live beams join the finished pool, best K overall win
    all_scores = torch.cat(
        [torch.where(fin_flags, fin_scores, NEG_INF), live_scores], dim=1)
    all_seqs = torch.cat([fin_seqs, live_seqs], dim=1)
    final_scores, sel = top_k(all_scores, K)
    return _gather_rows(all_seqs, sel), final_scores, cur_len - 1
