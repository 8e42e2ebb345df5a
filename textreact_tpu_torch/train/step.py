"""Train and eval steps (twin of textreact_tpu/train/step.py).

Replaces the reference's Lightning training_step / validation_step
(main.py:164-196). A step runs eagerly on one device: forward in training
mode, backward through the kernels' own backward passes, the optimizer's
update. Every dropout mask of a step comes from one `torch.Generator`
seeded from (the run's seed, the step, the micro-batch), so a step is
reproducible and no global generator is touched.

The entry points run on the CUDA card unless the caller passes `device=`;
they raise where no card is found, and where the module lies elsewhere.

On a mesh (a module that `parallel.sharding.shard_params` has cut; one
process per device) a step computes what the JAX package's global-array
step computes:
- each loss term divides this rank's sum by the count of the GLOBAL batch
  (the counts are all-reduced over the dp group before the forward), so
  that the dp ranks' terms add up to the global mean also when their
  shards hold different numbers of real rows;
- the gradients are all-reduced over the dp group once per optimizer step,
  after the accumulation (`Optimizer.update`), and the gradient norm sums
  the squares of tp-split gradients over the tp group;
- the dropout generator folds in the dp rank, never the tp rank: dp ranks
  draw different masks, and the tp ranks of a row draw the same residual
  masks on their replicated activations (and, through the kernels' head
  offset, the attention masks of their own heads).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.collate import IGNORE_INDEX
from ..models.factory import resolve_device
from . import losses
from .optim import Optimizer

Tensor = torch.Tensor
_MASK64 = (1 << 63) - 1


@dataclasses.dataclass
class TrainState:
    """The module, its optimizer (moments and update count) and the step.
    A train step updates all three in place and hands the state back."""
    module: torch.nn.Module
    optimizer: Optimizer
    step: int = 0

    @classmethod
    def create(cls, module: torch.nn.Module,
               optimizer: Optimizer) -> "TrainState":
        return cls(module=module, optimizer=optimizer, step=0)


def _check_device(module: torch.nn.Module, device) -> torch.device:
    device = resolve_device(device)
    where = next(module.parameters()).device
    if where.type != device.type:
        raise RuntimeError(f"the module lies on {where}, the step runs on "
                           f"{device}")
    return where


def to_device(batch: Mapping[str, Any], device: torch.device
              ) -> Dict[str, Tensor]:
    """A collated batch (numpy arrays, or a `Batch`) as tensors on `device`;
    integer arrays become int64, what torch indexes with."""
    arrays = getattr(batch, "arrays", batch)
    out = {}
    for name, value in arrays.items():
        t = torch.as_tensor(np.asarray(value) if not torch.is_tensor(value)
                            else value)
        if not t.is_floating_point():
            t = t.long()
        out[name] = t.to(device, non_blocking=True)
    return out


def _dropout_generator(gen: torch.Generator, seed: int, counter: int,
                       dp_rank: int = 0) -> torch.Generator:
    """Reseed `gen` from the run's seed, a step counter and the dp rank
    (the role of jax.random.fold_in(rng, counter)); dp rank 0 draws what
    one device draws."""
    gen.manual_seed((seed * 0x9E3779B97F4A7C15 + counter
                     + dp_rank * 0xD1B54A32D192ED03) & _MASK64)
    return gen


def _dp(module: torch.nn.Module):
    """The module's mesh when a dp group exists (also a group of one), else
    None: then nothing is reduced."""
    mesh = getattr(module, "mesh", None)
    return mesh if mesh is not None and mesh.distributed else None


def loss_counts(batch: Mapping[str, Any], cfg, dec_pad_id: int) -> Tensor:
    """The counts that divide the loss's terms (`losses.masked_mean`), in
    the order the loss adds them: the target tokens (template-based: atom
    labels, bond labels), then the MLM labels under --mlm. float32."""
    if cfg.template_based:
        labels = [(batch["atom_template_labels"], IGNORE_INDEX),
                  (batch["bond_template_labels"], IGNORE_INDEX)]
    else:
        labels = [(batch["decoder_input_ids"][:, 1:], dec_pad_id)]
    if cfg.mlm and "mlm_labels" in batch:
        labels.append((batch["mlm_labels"], IGNORE_INDEX))
    return torch.stack([(torch.as_tensor(t) != ignore).sum()
                        for t, ignore in labels]).float()


def _all_reduce(t: Tensor, mesh) -> Tensor:
    """Sum of `t` over the dp group (a new tensor)."""
    t = t.clone()
    torch.distributed.all_reduce(t, group=mesh.dp_group)
    return t


def _global_denoms(counts: Tensor, mesh) -> Tensor:
    return _all_reduce(counts, mesh).clamp(min=1)


def _model_inputs(batch: Dict[str, Tensor], template_based: bool,
                  mlm_prefix_len: Optional[int],
                  mlm_fused: bool = False) -> Dict[str, Any]:
    kw: Dict[str, Any] = dict(
        input_ids=batch["input_ids"],
        attention_mask=batch["attention_mask"],
    )
    if "position_ids" in batch:
        kw["position_ids"] = batch["position_ids"]
    if template_based:
        kw["atom_indices"] = batch["atom_indices"]
        kw["bond_pairs"] = batch["bond_pairs"]
    else:
        kw["decoder_input_ids"] = batch["decoder_input_ids"]
        kw["decoder_attention_mask"] = batch.get("decoder_attention_mask")
    if mlm_prefix_len is not None:
        kw["mlm_prefix_len"] = mlm_prefix_len
        if mlm_fused:   # fold projection + CE into the forward (ops/fused_ce)
            kw["mlm_labels"] = batch["mlm_labels"]
    return kw


def make_loss_fn(module: torch.nn.Module, cfg, dec_pad_id: int) -> Callable:
    """Builds loss_fn(batch, generator) -> (loss, metrics) over a batch of
    tensors on the module's device; the module must be in training mode for
    the dropouts to run."""
    template_based = cfg.template_based
    mlm_fused = getattr(cfg, "mlm_impl", "fused") == "fused"

    def loss_fn(batch: Dict[str, Tensor], generator: torch.Generator,
                denoms: Optional[Tensor] = None
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """`denoms`: the global counts of `loss_counts` (clamped to >= 1)
        that divide this rank's sums; None: the batch's own counts."""
        mlm_prefix = (batch["mlm_labels"].shape[1]
                      if cfg.mlm and "mlm_labels" in batch else None)
        d = [] if denoms is None else list(denoms.unbind())
        take = lambda: d.pop(0) if d else None   # noqa: E731 (in order)
        out = module(**_model_inputs(batch, template_based, mlm_prefix,
                                     mlm_fused), generator=generator)
        if template_based:
            atom_logits, bond_logits = out["logits"]
            loss = losses.template_loss(atom_logits, bond_logits,
                                        batch["atom_template_labels"],
                                        batch["bond_template_labels"],
                                        denoms=(take(), take()))
        else:
            loss = losses.seq2seq_loss(out["logits"],
                                       batch["decoder_input_ids"],
                                       dec_pad_id, cfg.label_smoothing,
                                       denom=take())
        metrics = {"train_loss": loss}
        if mlm_prefix is not None:
            d_mlm = take()
            if "mlm_loss_sum" in out:
                mloss = out["mlm_loss_sum"] / (
                    out["mlm_valid"].clamp(min=1) if d_mlm is None
                    else d_mlm)
            else:
                mloss = losses.mlm_loss(out["mlm_logits"],
                                        batch["mlm_labels"], d_mlm)
            loss = loss + cfg.mlm_lambda * mloss
            metrics["mlm_loss"] = mloss
            metrics["total_loss"] = loss
        return loss, metrics

    return loss_fn


def _detached(metrics: Dict[str, Tensor], mesh=None) -> Dict[str, Tensor]:
    """The metrics without their graphs; on a mesh, each the sum of the dp
    ranks' terms (the global value)."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if mesh is None:
        return metrics
    total = _all_reduce(torch.stack(list(metrics.values())), mesh)
    return dict(zip(metrics, total.unbind()))


def make_train_step(module: torch.nn.Module, cfg, optimizer: Optimizer,
                    dec_pad_id: int, device=None) -> Callable:
    """train_step(state, batch, seed) -> (state, metrics). Metrics are
    0-dim tensors on the device (`train_loss`, with MLM `mlm_loss` and
    `total_loss`, and `grad_norm`, the global norm before the clip)."""
    device = _check_device(module, device)
    loss_fn = make_loss_fn(module, cfg, dec_pad_id)
    gen = torch.Generator(device=device)
    mesh = _dp(module)
    dp_rank = 0 if mesh is None else mesh.dp_rank

    def train_step(state: TrainState, batch: Mapping[str, Any], seed: int
                   ) -> Tuple[TrainState, Dict[str, Tensor]]:
        module.train()
        optimizer.zero_grad()
        batch = to_device(batch, device)
        denoms = (None if mesh is None else _global_denoms(
            loss_counts(batch, cfg, dec_pad_id), mesh))
        loss, metrics = loss_fn(
            batch, _dropout_generator(gen, seed, state.step, dp_rank), denoms)
        loss.backward()
        metrics = _detached(metrics, mesh)
        metrics["grad_norm"] = optimizer.update()
        state.step += 1
        return state, metrics

    return train_step


def make_accum_train_step(module: torch.nn.Module, cfg, optimizer: Optimizer,
                          dec_pad_id: int, device=None) -> Callable:
    """Gradient accumulation over the leading micro-batch axis (reference
    accumulate_grad_batches, main.py:381).

    train_step(state, microbatches, mb_weights, seed): every array of
    `microbatches` has a leading axis of n micro-batches; `mb_weights` (n,)
    marks real ones with 1.0 and the padding of a trailing partial window
    with 0.0. Gradients and loss average over the weight sum. A weight-0
    micro-batch contributes 0 * its gradient, so it is not run at all.
    On a mesh every micro-batch's loss divides by its global counts (one
    all-reduce of all the counts before the first forward), and the dp
    ranks must hold the same weights."""
    device = _check_device(module, device)
    loss_fn = make_loss_fn(module, cfg, dec_pad_id)
    gen = torch.Generator(device=device)
    mesh = _dp(module)
    dp_rank = 0 if mesh is None else mesh.dp_rank

    def train_step(state: TrainState, microbatches: Mapping[str, Any],
                   mb_weights: Sequence[float], seed: int
                   ) -> Tuple[TrainState, Dict[str, Tensor]]:
        module.train()
        optimizer.zero_grad()
        arrays = getattr(microbatches, "arrays", microbatches)
        weights = [float(w) for w in np.asarray(mb_weights, dtype=np.float32)]
        denoms = [None] * len(weights)
        if mesh is not None:
            counts = torch.stack([
                loss_counts({k: v[i] for k, v in arrays.items()}, cfg,
                            dec_pad_id) for i in range(len(weights))])
            denoms = _global_denoms(counts.to(device), mesh).unbind()
        loss_sum = torch.zeros((), device=device)
        for i, w in enumerate(weights):
            if w == 0.0:
                continue
            mb = to_device({k: v[i] for k, v in arrays.items()}, device)
            loss, _ = loss_fn(
                mb, _dropout_generator(gen, seed, state.step * 1009 + i,
                                       dp_rank), denoms[i])
            (loss * w).backward()
            loss_sum += loss.detach() * w
        if mesh is not None:
            loss_sum = _all_reduce(loss_sum, mesh)
        denom = max(sum(weights), 1.0)
        grads = [p.grad for p in optimizer.params if p.grad is not None]
        if grads:
            torch._foreach_div_(grads, denom)
        grad_norm = optimizer.update()
        state.step += 1
        return state, {"train_loss": loss_sum / denom, "grad_norm": grad_norm}

    return train_step


def make_eval_step(module: torch.nn.Module, cfg, dec_pad_id: int,
                   edit_topk: int = 500, device=None) -> Callable:
    """Per-example val scores (reference validation_step, main.py:177-188):
    acc = greedy exact match, loss = per-example mean CE.

    Template-based models return the top-`edit_topk` edit candidates ranked
    on the device (`device_topk_edits` over the flattened atom and bond
    probabilities) instead of the full (B, A, n_a+1) / (B, MB, n_b+1)
    probability tensors: the host merges two k-long lists per example
    (edits_from_topk), where the reference argsorts the full grids on the
    host (utils.py:79-108)."""
    template_based = cfg.template_based
    device = _check_device(module, device)

    @torch.no_grad()
    def eval_step(batch: Mapping[str, Any]) -> Dict[str, Tensor]:
        module.eval()
        batch = to_device(batch, device)
        out = module(**_model_inputs(batch, template_based, None))
        if template_based:
            from ..evaluation.edit_rank import device_topk_edits
            atom_logits, bond_logits = out["logits"]
            atom_labels = batch["atom_template_labels"]
            bond_labels = batch["bond_template_labels"]
            res = {"example_mask": batch["example_mask"],
                   "indices": batch["indices"],
                   "loss": losses.template_loss(
                       atom_logits, bond_logits, atom_labels, bond_labels,
                       reduction="none")}
            (res["atom_topk_vals"], res["atom_topk_idx"],
             res["bond_topk_vals"], res["bond_topk_idx"]) = device_topk_edits(
                losses.masked_probs(atom_logits, atom_labels),
                losses.masked_probs(bond_logits, bond_labels),
                bond_labels != losses.IGNORE_INDEX, edit_topk)
            return res
        return {
            "example_mask": batch["example_mask"],
            "indices": batch["indices"],
            "loss": losses.seq2seq_loss(
                out["logits"], batch["decoder_input_ids"], dec_pad_id,
                reduction="none"),
            "acc": losses.seq2seq_greedy_acc(
                out["logits"], batch["decoder_input_ids"], dec_pad_id),
        }

    return eval_step
