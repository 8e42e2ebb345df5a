"""Beam search over a row-stable KV cache (twin of
textreact_tpu/inference/beam.py).

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

The self-attention cache is row-stable, as in the JAX package: beams that
fork or reorder never move it. Beam j's token of a step is written to
cache row j; a (B, K, T) ancestor table `src` records which row holds each
beam's history at each position, beams inherit their parent's rows of it,
and `ancestor_bias` turns it into the additive bias under which each beam
attends over exactly its own history. The decode runs one loop per window
of a static schedule (`_plan_windows`): within a window the bias, and with
it the cache prefix the attention reads, spans `window` positions.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

NEG_INF = -1.0e7
NEG_INF_BIAS = -1.0e9  # attention-bias masking (models/layers.py NEG_INF)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, best first, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (B, N, T), idx: (B, M) -> (B, M, T)."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def ancestor_bias(src: torch.Tensor, cur_len: int, B: int, K: int,
                  T: int) -> torch.Tensor:
    """(B, K, T*K) f32 additive attention bias from the ancestor table,
    the merged KV axis in (t, g) order, as the grouped cache lays it out
    (models/layers.py: (Bex, H, D, T*G)).

    src[b, j, t] = the cache row holding beam j's key/value at position t.
    Each beam attends over all T*K slots of its example; this bias admits
    exactly one row per position below cur_len, its ancestor's, so the
    softmax over the masked T*K axis equals the softmax over the beam's own
    history."""
    rows = torch.arange(K, device=src.device)
    valid = src[:, :, :, None] == rows                          # (B,K,T,K)
    valid &= (torch.arange(T, device=src.device) < cur_len)[:, None]
    return torch.where(valid.reshape(B, K, T * K), 0.0,
                       NEG_INF_BIAS).to(torch.float32)


def _plan_windows(T: int, user: Optional[Sequence[int]]) -> list:
    """Static attention-window schedule: early decode steps attend over a
    prefix of the cache (the bias width tells the attention how much to
    read), so a step's cache reads track the decoded length instead of the
    cache capacity. Short caches get a single window."""
    if user is not None:
        ws = sorted({min(int(w), T) for w in user})
        return ws if ws and ws[-1] == T else ws + [T]
    if T <= 48:
        return [T]
    quarter = max(16, -(-T // 4 // 16) * 16)
    half = max(quarter, -(-T // 2 // 16) * 16)
    return [w for w in (quarter, half) if w < T] + [T]


def beam_search(step_fn: Callable[[torch.Tensor, int, torch.Tensor],
                                  torch.Tensor],
                batch_size: int, num_beams: int, max_length: int,
                bos_token_id: int, eos_token_id: int, pad_token_id: int,
                attn_windows: Optional[Sequence[int]] = None,
                device=None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Returns (sequences (B, K, max_length), scores (B, K), steps run),
    best first.

    step_fn(tokens (B*K, 1), position, beam_bias (B, K, W*K)) -> logits
    (B*K, 1, V) or (B*K, V), where W is the step's window; it writes the
    tokens' K/V to cache rows 0..B*K-1 at `position` and never moves a
    row."""
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
    src = torch.zeros((B, K, T), dtype=torch.long, device=device)
    own_rows = torch.arange(K, device=device)[None, :].expand(B, K)
    rank = torch.arange(2 * K, device=device)[None, :]

    def improvable() -> bool:
        worst_fin = torch.where(fin_flags, fin_scores, NEG_INF).amin(dim=1)
        best_live = live_scores.amax(dim=1)
        return bool(((best_live > worst_fin) | ~fin_flags.all(dim=1)).any())

    cur_len = 1
    windows = _plan_windows(T, attn_windows)
    for wi, W in enumerate(windows):
        last = wi == len(windows) - 1
        while (cur_len < T if last else cur_len <= W) and improvable():
            # the token fed at cur_len - 1 belongs to live beam j, and its
            # K/V go to cache row j
            src[:, :, cur_len - 1] = own_rows
            beam_bias = ancestor_bias(src[:, :, :W], cur_len, B, K, W)
            logits = step_fn(live_seqs[:, :, cur_len - 1].reshape(B * K, 1),
                             cur_len - 1, beam_bias)
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
            # beams fork and reorder by inheriting their parent's ancestor
            # rows; the cache itself is never touched
            src = _gather_rows(src, torch.gather(beam_idx, 1, live_sel))

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
