"""The numbers that decide `correct`: what the timed path produced, held
against the plain reference (`portbench/reference/`), each beside its
limit. The limits of a cell are in `portbench/limits/<cell>.json`, set from
the readings that `portbench/calibrate.py` takes on the chip.

Training (the first three steps of the object the window drives):
- `loss_gap`: the widest gap between a step's loss and the reference's, as
  a share of the reference's;
- `grad_gap`: over the leaves, the gap between the norms of the first
  gradient as the optimizer got it (its first moment after one step, over
  1 - b1) and the reference's clipped gradient, as a share of the larger of
  the leaf's reference norm and the median leaf's;
- `update_gap`: the same for the parameters' change over the three steps,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a key's bias, whose gradient is nought under softmax,
  moves under Adam by round-off alone).

Serving (a sample of the requests the window finished, drawn from the
seed, the longest among them):
- `score_gap`: the widest gap, in nats, between a served beam's score and
  the reference's log-probability of the same tokens, teacher-forced;
- `select_gap`: at the last step, how far (nats, by the reference) the
  best child of the served live beams' parents that was not served lies
  above the worst served live beam: beam search keeps the best children,
  so a child that beats a served one was wrongly dropped;
- `score_median`, `select_median`: the median over the sampled requests
  of each one's score gap (its widest beam) or selection gap: steadier
  from seed to seed than the widest.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def load_limits(cell: str) -> Dict[str, float]:
    path = HERE / "limits" / f"{cell}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no limits for cell {cell!r} ({path})")
    return {k: float(v["limit"]) for k, v in
            json.loads(path.read_text())["numbers"].items()}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Optional[Sequence[str]] = None) -> Tuple[float, str]:
    """(the widest |prog - ref| / max(ref, median ref) over `leaves`, the
    leaf where it is)."""
    names = list(ref) if leaves is None else list(leaves)
    med = statistics.median(ref[n] for n in names)
    worst, where = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if gap > worst:
            worst, where = gap, n
    return worst, where


def moving_leaves(grad_ref: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient norm is at least a thousandth of the
    median leaf's."""
    med = statistics.median(grad_ref.values())
    return [n for n, g in grad_ref.items() if g >= 1e-3 * med]


def train_numbers(losses_prog: Sequence[float], losses_ref: Sequence[float],
                  grad_prog: Dict[str, float], grad_ref: Dict[str, float],
                  delta_prog: Dict[str, float], delta_ref: Dict[str, float]
                  ) -> Dict[str, Tuple[float, str]]:
    loss = max(abs(a - b) / abs(b) for a, b in zip(losses_prog, losses_ref))
    return {"loss_gap": (loss, ""),
            "grad_gap": leaf_gap(grad_prog, grad_ref),
            "update_gap": leaf_gap(delta_prog, delta_ref,
                                   moving_leaves(grad_ref))}


# --- serving ----------------------------------------------------------------

def served_end(seq: np.ndarray, steps: int, eos: int) -> int:
    """The last served position of a beam: its EOS, else the search's last
    step."""
    hits = np.flatnonzero(seq[1:steps + 1] == eos)
    return int(hits[0]) + 1 if len(hits) else steps


def beam_logp(model, enc: torch.Tensor, enc_mask: torch.Tensor,
              seqs: np.ndarray) -> torch.Tensor:
    """(K, T - 1, V) log-probabilities of each position's next token, for
    the K beams of one request, teacher-forced through `model`."""
    ids = torch.as_tensor(seqs, dtype=torch.long, device=enc.device)
    K = ids.shape[0]
    logits = model.decode(ids, enc.expand(K, -1, -1),
                          enc_mask.expand(K, -1))
    return torch.log_softmax(logits[:, :-1].float(), dim=-1)


def request_numbers(logp: torch.Tensor, seqs: np.ndarray,
                    scores: np.ndarray, steps: int, eos: int,
                    chooser: Optional[torch.Tensor] = None
                    ) -> Tuple[float, float, np.ndarray]:
    """(score gap, select gap, reference scores) of one request's K served
    beams. `chooser`, (K, T - 1, V) log-probabilities of another model, makes
    the last step's choice among the children in the served one's place
    (the control's choice)."""
    K = seqs.shape[0]
    lp = logp.double().cpu().numpy()
    ref = np.zeros(K)
    ends = [served_end(seqs[k], steps, eos) for k in range(K)]
    for k in range(K):
        t = np.arange(1, ends[k] + 1)
        ref[k] = lp[k, t - 1, seqs[k, t]].sum()
    score_gap = float(np.max(np.abs(scores - ref)))
    # the last step: live served beams (no EOS, at the last step)
    live = [k for k in range(K)
            if ends[k] == steps and seqs[k, steps] != eos]
    if not live:
        return score_gap, 0.0, ref
    served = {tuple(seqs[k, :steps + 1]) for k in live}
    parents: Dict[tuple, int] = {}
    for k in live:
        parents.setdefault(tuple(seqs[k, :steps]), k)
    cand_ref, cand_key, cand_choose = [], [], []
    ch = None if chooser is None else chooser.double().cpu().numpy()
    for prefix, k in parents.items():
        base = ref[k] - lp[k, steps - 1, seqs[k, steps]]
        alt = None
        if ch is not None:
            t = np.arange(1, steps)
            alt = ch[k, t - 1, seqs[k, t]].sum()
        for v in range(lp.shape[-1]):
            if v == eos:
                continue
            cand_ref.append(base + lp[k, steps - 1, v])
            cand_key.append(prefix + (v,))
            if ch is not None:
                cand_choose.append(alt + ch[k, steps - 1, v])
    cand_ref = np.array(cand_ref)
    if ch is None:
        chosen = np.array([key in served for key in cand_key])
    else:   # the control keeps as many children as were served
        chosen = np.zeros(len(cand_key), bool)
        chosen[np.argsort(-np.array(cand_choose), kind="stable")
               [:len(served)]] = True
    select_gap = max(0.0, float(cand_ref[~chosen].max()
                                - cand_ref[chosen].min()))
    return score_gap, select_gap, ref


def pick_requests(n_done: int, count: int, longest: int,
                  seed: int) -> List[int]:
    """`count` of the `n_done` finished requests, drawn from the seed, the
    one at `longest` always among them."""
    rng = np.random.default_rng([seed, 0x5E7E])
    rest = [i for i in rng.permutation(n_done) if i != longest]
    return [longest] + [int(i) for i in rest[:count - 1]]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)


def report_lines(numbers: Dict[str, float], limits: Dict[str, float]
                 ) -> List[str]:
    return [f"check {k}: {numbers[k]!r} limit {limits[k]!r}"
            for k in limits]
