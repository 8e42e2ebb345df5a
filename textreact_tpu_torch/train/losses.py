"""Loss and accuracy computation (twin of textreact_tpu/train/losses.py).

Parity: reference main.py:112-162 (compute_loss / compute_acc /
compute_mlm_loss), including the exact reduction semantics:

- 'mean' = mean over non-ignored target tokens across the whole batch
  (torch F.cross_entropy with ignore_index);
- 'none' = per-example mean over ALL positions, where ignored positions
  contribute 0 (torch reduction='none' zeroes ignored elements, then the
  reference takes .mean(dim=1) over the full length, main.py:124-133).

Batch-padding rows (example_mask == 0) carry all-ignored labels, so they
contribute nothing to sums; per-example outputs are masked by the caller.

A 'mean' may be given its denominator (`denom`): a data-parallel rank
divides its own sum by the count of the whole global batch, so that the
ranks' terms add up to the global mean (train/step.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..data.collate import IGNORE_INDEX

Tensor = torch.Tensor


def cross_entropy_elements(logits: Tensor, labels: Tensor, ignore_id: int,
                           label_smoothing: float = 0.0
                           ) -> Tuple[Tensor, Tensor]:
    """Per-element CE with 0 at ignored positions. Returns (loss, valid)."""
    valid = labels != ignore_id
    safe_labels = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe_labels[..., None])[..., 0]
    if label_smoothing > 0.0:
        smooth = -logp.mean(-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return torch.where(valid, nll, 0.0), valid


def masked_mean(loss_elems: Tensor, valid: Tensor,
                denom: Optional[Tensor] = None) -> Tensor:
    """The sum over valid elements divided by their count, or by `denom`."""
    if denom is None:
        denom = valid.sum().clamp(min=1)
    return loss_elems.sum() / denom


def seq2seq_loss(logits: Tensor, decoder_input_ids: Tensor, pad_id: int,
                 label_smoothing: float = 0.0,
                 reduction: str = "mean",
                 denom: Optional[Tensor] = None) -> Tensor:
    """CE over shifted decoder tokens, pad ignored (main.py:128-133)."""
    labels = decoder_input_ids[:, 1:]
    elems, valid = cross_entropy_elements(logits[:, :-1], labels, pad_id,
                                          label_smoothing)
    if reduction == "mean":
        return masked_mean(elems, valid, denom)
    return elems.mean(1)  # per-example mean over all positions


def seq2seq_greedy_acc(logits: Tensor, decoder_input_ids: Tensor,
                       pad_id: int) -> Tensor:
    """Per-example greedy exact-match accuracy (main.py:150-153): argmax
    matches label at every position, pad positions auto-pass."""
    preds = logits[:, :-1].argmax(-1)
    labels = decoder_input_ids[:, 1:]
    ok = (preds == labels) | (labels == pad_id)
    return ok.all(-1).float()


def template_loss(atom_logits: Tensor, bond_logits: Tensor,
                  atom_labels: Tensor, bond_labels: Tensor,
                  reduction: str = "mean",
                  denoms: Optional[Sequence[Tensor]] = None) -> Tensor:
    """Atom + bond template CE (main.py:114-126). Labels are IGNORE_INDEX at
    non-atoms / non-bonds / padding. `denoms`: (atom, bond) denominators."""
    a_elems, a_valid = cross_entropy_elements(atom_logits, atom_labels,
                                              IGNORE_INDEX)
    b_elems, b_valid = cross_entropy_elements(bond_logits, bond_labels,
                                              IGNORE_INDEX)
    if reduction == "mean":
        a_d, b_d = (None, None) if denoms is None else denoms
        return (masked_mean(a_elems, a_valid, a_d)
                + masked_mean(b_elems, b_valid, b_d))
    return a_elems.mean(1) + b_elems.mean(1)


def mlm_loss(mlm_logits: Tensor, mlm_labels: Tensor,
             denom: Optional[Tensor] = None) -> Tensor:
    """CE over the masked prefix (main.py:158-162; torch CE default mean
    over non-ignored)."""
    elems, valid = cross_entropy_elements(mlm_logits, mlm_labels,
                                          IGNORE_INDEX)
    return masked_mean(elems, valid, denom)


def masked_probs(logits: Tensor, labels: Tensor) -> Tensor:
    """softmax probs with ignored positions zeroed (main.py:140-143,
    202-206): template-based eval edit ranking."""
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.where((labels != IGNORE_INDEX)[..., None], probs, 0.0)
