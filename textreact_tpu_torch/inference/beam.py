"""Beam search over a row-stable KV cache, its state kept on the device
(twin of textreact_tpu/inference/beam.py).

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

As the JAX package's `lax.while_loop`, the loop's state lives on the
device (`BeamState`: the position `cur_len` too, as a 0-d tensor) and its
body (`beam_step`) is a function of device tensors alone, updated in place:
nothing in it waits for the host, so a CUDA graph can hold it
(inference/graphs.py). The loop's condition is evaluated on the device as
well: `done` is set when no live beam can improve the finished pool or the
cache is full, and a body entered past its window or after `done` leaves
every state tensor as it was. So the host can run a window's steps without
reading anything, and stop on a flag it reads some steps late
(`StopFlags`); on the CPU it reads the flag after every step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

NEG_INF = -1.0e7
NEG_INF_BIAS = -1.0e9  # attention-bias masking (models/layers.py NEG_INF)
# on the card, the host reads the stop flag of the step this many steps
# back, so that the card always has that many steps queued; at most this
# many steps run after the stop, and they change nothing
STOP_LAG = 2


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, best first, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (B, N, T), idx: (B, M) -> (B, M, T)."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def ancestor_bias(src: torch.Tensor, cur_len: Union[int, torch.Tensor],
                  B: int, K: int, T: int) -> torch.Tensor:
    """(B, K, T*K) f32 additive attention bias from the ancestor table,
    the merged KV axis in (t, g) order, as the grouped cache lays it out
    (models/layers.py: (Bex, H, D, T*G)). `cur_len`: an int, or a 0-d
    tensor on src's device.

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


@dataclasses.dataclass(frozen=True)
class Window:
    """One loop of the schedule: the bias width, whether it is the last
    loop (it runs while cur_len < T, the others while cur_len <= width),
    and the steps it runs when nothing stops the search."""
    width: int
    last: bool
    steps: int


def window_plan(T: int, attn_windows: Optional[Sequence[int]] = None
                ) -> List[Window]:
    """The schedule's loops and their step counts: without a stop,
    cur_len advances by one a step from 1, so each loop's count is known
    on the host."""
    widths = _plan_windows(T, attn_windows)
    plan, start = [], 1
    for i, W in enumerate(widths):
        last = i == len(widths) - 1
        n = max(0, (T - 1 if last else W) - start + 1)
        plan.append(Window(W, last, n))
        start += n
    return plan


@dataclasses.dataclass
class BeamState:
    """The search's state on the device, updated in place (the JAX
    while_loop's carry). cur_len: 0-d int64, the next position to fill
    (the steps run are cur_len - 1); live_seqs / fin_seqs (B, K, T) int64;
    live_scores / fin_scores (B, K) f32; fin_flags (B, K) bool; src (B, K,
    T) int64, the ancestor table; done: 0-d bool, set when the search is
    over."""
    cur_len: torch.Tensor
    live_seqs: torch.Tensor
    live_scores: torch.Tensor
    fin_seqs: torch.Tensor
    fin_scores: torch.Tensor
    fin_flags: torch.Tensor
    src: torch.Tensor
    done: torch.Tensor

    @classmethod
    def allocate(cls, B: int, K: int, T: int, device=None) -> "BeamState":
        """Uninitialised tensors; `reset` fills them."""
        long = dict(dtype=torch.long, device=device)
        return cls(
            cur_len=torch.empty((), **long),
            live_seqs=torch.empty((B, K, T), **long),
            live_scores=torch.empty((B, K), device=device),
            fin_seqs=torch.empty((B, K, T), **long),
            fin_scores=torch.empty((B, K), device=device),
            fin_flags=torch.empty((B, K), dtype=torch.bool, device=device),
            src=torch.empty((B, K, T), **long),
            done=torch.empty((), dtype=torch.bool, device=device))

    def tensors(self) -> List[torch.Tensor]:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def reset(self, bos_token_id: int, pad_token_id: int) -> None:
        """The state before the first step, written in place."""
        self.cur_len.fill_(1)
        self.live_seqs.fill_(pad_token_id)
        self.live_seqs[:, :, 0] = bos_token_id
        # only beam 0 is a real hypothesis at the start
        self.live_scores.fill_(NEG_INF)
        self.live_scores[:, 0] = 0.0
        self.fin_seqs.fill_(pad_token_id)
        self.fin_scores.fill_(NEG_INF)
        self.fin_flags.zero_()
        self.src.zero_()
        self.done.zero_()


def _improvable(fin_flags: torch.Tensor, fin_scores: torch.Tensor,
                live_scores: torch.Tensor) -> torch.Tensor:
    """0-d bool: a live beam can still enter the finished pool, i.e. its
    (non-increasing) score beats the worst finished one or a slot is empty
    (the JAX loop's cond, early_stopping=False)."""
    worst_fin = torch.where(fin_flags, fin_scores, NEG_INF).amin(dim=1)
    best_live = live_scores.amax(dim=1)
    return ((best_live > worst_fin) | ~fin_flags.all(dim=1)).any()


StepFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def beam_step(s: BeamState, step_fn: StepFn, window: Window,
              eos_token_id: int) -> None:
    """One step of the search, in place on `s`: the JAX package's loop
    body (beam.py:117-170) behind its cond (beam.py:101-111), evaluated
    here on the device. Where the cond is false (past the window, or
    `done`), every state tensor keeps its bits and cur_len stays.

    step_fn(tokens (B*K, 1), position (0-d tensor), beam_bias (B, K, W*K))
    -> logits (B*K, 1, V) or (B*K, V); it writes the tokens' K/V to cache
    rows 0..B*K-1 at `position` and never moves a row. A step that changes
    nothing still calls it, at position cur_len - 1: a slot that no beam's
    history holds yet, and that the next real step writes first."""
    B, K, T = s.live_seqs.shape
    W, cur = window.width, s.cur_len
    active = (cur < T if window.last else cur <= W) & ~s.done
    pos = cur - 1
    # the token fed at cur_len - 1 belongs to live beam j, and its K/V go
    # to cache row j
    src = s.src.index_copy(
        2, pos.view(1), torch.arange(K, device=cur.device)[None, :, None]
        .expand(B, K, 1))
    beam_bias = ancestor_bias(src[:, :, :W], cur, B, K, W)
    tokens = s.live_seqs.index_select(2, pos.view(1)).reshape(B * K, 1)
    logits = step_fn(tokens, pos, beam_bias)
    V = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1).view(B, K, V)
    cand = (s.live_scores[:, :, None] + logp).view(B, K * V)
    topv, topi = top_k(cand, 2 * K)                             # (B, 2K)
    beam_idx = topi // V
    tok_idx = topi % V
    cand_seqs = _gather_rows(s.live_seqs, beam_idx)
    # at cur_len == T only a step that changes nothing gets here: its write
    # goes to the last slot and is discarded below
    cand_seqs.index_copy_(2, cur.clamp(max=T - 1).view(1),
                          tok_idx[:, :, None])
    is_eos = tok_idx == eos_token_id

    # next live beams: the best K non-EOS candidates
    live_scores, live_sel = top_k(torch.where(is_eos, NEG_INF, topv), K)
    live_seqs = _gather_rows(cand_seqs, live_sel)
    # beams fork and reorder by inheriting their parent's ancestor rows;
    # the cache itself is never touched
    src = _gather_rows(src, torch.gather(beam_idx, 1, live_sel))

    # finished pool: EOS candidates ranked < K among the 2K
    eos_kept = is_eos & (torch.arange(2 * K, device=cur.device) < K)
    all_scores = torch.cat(
        [s.fin_scores, torch.where(eos_kept, topv, NEG_INF)], dim=1)
    all_flags = torch.cat([s.fin_flags, eos_kept], dim=1)
    all_seqs = torch.cat([s.fin_seqs, cand_seqs], dim=1)
    fin_scores, fin_sel = top_k(all_scores, K)
    fin_seqs = _gather_rows(all_seqs, fin_sel)
    fin_flags = torch.gather(all_flags, 1, fin_sel)

    for old, new in ((s.live_seqs, live_seqs), (s.live_scores, live_scores),
                     (s.fin_seqs, fin_seqs), (s.fin_scores, fin_scores),
                     (s.fin_flags, fin_flags), (s.src, src)):
        torch.where(active, new, old, out=old)
    s.cur_len.add_(active.long())
    # the cond of the next step, less its window: the search is over when
    # no live beam can improve the finished pool or the cache is full
    s.done.copy_(s.done | (s.cur_len >= T) | ~_improvable(
        s.fin_flags, s.fin_scores, s.live_scores))


def finalize(s: BeamState) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF finalize: live beams join the finished pool, the best K overall
    win. Returns (sequences (B, K, T), scores (B, K)), best first."""
    K = s.live_scores.shape[1]
    all_scores = torch.cat(
        [torch.where(s.fin_flags, s.fin_scores, NEG_INF), s.live_scores],
        dim=1)
    all_seqs = torch.cat([s.fin_seqs, s.live_seqs], dim=1)
    final_scores, sel = top_k(all_scores, K)
    return _gather_rows(all_seqs, sel), final_scores


class StopFlags:
    """The host's reads of a state's `done` flag, one after each step.

    On the CPU each step's flag is read as it is made. On the card each
    flag is copied into pinned host memory behind its step, and the host
    reads the one `lag` steps back once its copy has landed (an event
    behind each copy): the card keeps `lag` steps queued, and after a stop
    at most `lag` steps run that change nothing."""

    def __init__(self, done: torch.Tensor, lag: int = STOP_LAG):
        self.done = done
        self.lag = lag
        self.steps = 0
        if done.is_cuda:
            self.host = torch.zeros(lag + 1, dtype=torch.bool,
                                    pin_memory=True)
            self.events = [torch.cuda.Event() for _ in range(lag + 1)]

    def stopped(self) -> bool:
        """Call after each step: whether a stop has been read."""
        self.steps += 1
        if not self.done.is_cuda:
            return bool(self.done)
        n = self.lag + 1
        i = (self.steps - 1) % n
        self.host[i].copy_(self.done, non_blocking=True)
        self.events[i].record()
        if self.steps <= self.lag:
            return False
        j = (self.steps - 1 - self.lag) % n
        self.events[j].synchronize()
        return bool(self.host[j])


def run_windows(plan: Sequence[Window], step: Callable[[int], None],
                flags: StopFlags) -> int:
    """Run `step(i)` for each loop i of the plan, its count of times, until
    `flags` reads a stop. Returns the steps run (those past a stop
    included)."""
    for i, window in enumerate(plan):
        for _ in range(window.steps):
            step(i)
            if flags.stopped():
                return flags.steps
    return flags.steps


def beam_search(step_fn: StepFn,
                batch_size: int, num_beams: int, max_length: int,
                bos_token_id: int, eos_token_id: int, pad_token_id: int,
                attn_windows: Optional[Sequence[int]] = None,
                device=None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Returns (sequences (B, K, max_length), scores (B, K), steps run),
    best first; the loop uncaptured, its state on `device`.

    step_fn(tokens (B*K, 1), position, beam_bias (B, K, W*K)) -> logits
    (B*K, 1, V) or (B*K, V), where W is the step's window and `position` a
    0-d int64 tensor on the device; it writes the tokens' K/V to cache rows
    0..B*K-1 at `position` and never moves a row."""
    state = BeamState.allocate(batch_size, num_beams, max_length, device)
    state.reset(bos_token_id, pad_token_id)
    plan = window_plan(max_length, attn_windows)
    run_windows(plan, lambda i: beam_step(state, step_fn, plan[i],
                                          eos_token_id),
                StopFlags(state.done))
    seqs, scores = finalize(state)
    return seqs, scores, int(state.cur_len) - 1
