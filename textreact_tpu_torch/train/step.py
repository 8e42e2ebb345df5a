"""Train and eval steps (twin of textreact_tpu/train/step.py).

Replaces the reference's Lightning training_step / validation_step
(main.py:164-196). A step runs on one device: forward in training mode,
backward through the kernels' own backward passes, the optimizer's
update; on a card as CUDA graphs, replayed (`TrainStep`,
train/graphs.py), the JAX step's one jitted program. The eval step's
forward is graphed the same way (`EvalStep`). Every dropout mask
of a step comes from one `torch.Generator` seeded from (the run's seed,
the step, the micro-batch), so a step is reproducible and no global
generator is touched.

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
from ..utils.profiling import span
from . import losses
from .graphs import EvalGraphs, TrainGraphs
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


# the train step's routes: CUDA graphs (one card's), or the same two parts
# run as they are (the CPU's, a mesh's and remat's)
CUDA_GRAPHS, UNCAPTURED = "cuda_graphs", "uncaptured"


def train_route(module: torch.nn.Module, device: torch.device) -> str:
    """The route of a train step of `module` on `device`: graphs on a card,
    unless the step holds a collective (a mesh: gloo cannot be captured,
    and NCCL capture is not done yet) or remat, whose recomputation sets
    the dropout generator's state on the host (models/layers.py
    `remat_block`), which no capture can hold."""
    remat = any(getattr(m, "remat", False) for m in module.modules())
    return (CUDA_GRAPHS if device.type == "cuda" and _dp(module) is None
            and not remat else UNCAPTURED)


class TrainStep:
    """A train step of one module, as two parts that a CUDA graph can hold
    (the port's counterpart of the JAX step's one `jax.jit` program):

    - the micro-batch part: forward, the backward of `loss * w` into the
      `.grad` buffers (allocated once by `Optimizer.ensure_grads`,
      accumulated in place) and `loss_sum += w * loss` (accumulation); or
      forward, backward and the metrics into their buffers (one batch);
    - the update part: the gradients divided by the weight sum (a device
      scalar), then `Optimizer.apply` (norm, clip, AdamW, the gradients
      zeroed in place).

    Every tensor that outlives a part is allocated outside any graph: the
    gradients, the moments, `loss_sum`, the weight, the weight sum and the
    metric outputs, which the next step overwrites; a call returns clones.
    The host does what no graph can: it reseeds the dropout generator for
    each micro-batch, skips weight-0 micro-batches (their weights are known
    before any part runs), and writes the weight, the weight sum and the
    scheduled rate into their buffers.

    `route` is chosen once (`train_route`) and printed by the callers. On
    "cuda_graphs" each shape key (the sorted names, per-micro-batch shapes
    and dtypes of the arrays) has static inputs and a graph of the
    micro-batch part, and one graph of the update part serves every key
    (train/graphs.py). On "uncaptured" the same parts run as they are;
    setting `route` to it on a card gives the reference the graphs are held
    to. A call is the span `train.step`, and holds `train.stage` and
    `train.micro` a micro-batch run, then `train.update`
    (utils/profiling.py), on either route."""

    def __init__(self, module: torch.nn.Module, cfg, optimizer: Optimizer,
                 dec_pad_id: int, device=None):
        self.device = _check_device(module, device)
        self.module, self.cfg, self.optimizer = module, cfg, optimizer
        self.dec_pad_id = dec_pad_id
        self.loss_fn = make_loss_fn(module, cfg, dec_pad_id)
        self.gen = torch.Generator(device=self.device)
        self.mesh = _dp(module)
        self.dp_rank = 0 if self.mesh is None else self.mesh.dp_rank
        self.route = train_route(module, self.device)
        self.graphs = None   # train/graphs.py TrainGraphs, at the first call
        self.outputs: Dict[str, Tensor] = {}
        self._started = False

    # --- the two parts are a subclass's `_micro` and `_update` ---------
    def _output(self, name: str) -> Tensor:
        """The buffer of metric `name`, allocated at the first, uncaptured
        run of a part."""
        out = self.outputs.get(name)
        if out is None:
            out = self.outputs[name] = torch.zeros((), device=self.device)
        return out

    # --- the host's share ---------------------------------------------
    def _begin(self, arrays: Mapping[str, Any], stacked: bool):
        """The static inputs and graph of the arrays' key on the graphed
        route (None on the other)."""
        self.module.train()
        if not self._started:   # whatever a caller left in .grad
            self.optimizer.ensure_grads()
            self.optimizer.zero_grad()
            self._started = True
        if self.route != CUDA_GRAPHS:
            return None
        if self.graphs is None:
            self.graphs = TrainGraphs(self.device, self.gen)
        self.graphs.check_grads(self.optimizer)
        return self.graphs.key(arrays, stacked)

    def _micro_batch(self, key, arrays, i: Optional[int],
                     denoms: Optional[Tensor], counter: int,
                     seed: int) -> None:
        """Reseed the generator for this micro-batch, then run or replay
        the micro-batch part on micro-batch `i` of `arrays` (all of them
        when None)."""
        _dropout_generator(self.gen, seed, counter, self.dp_rank)
        if key is None:
            with span("train.stage"):
                batch = to_device(arrays if i is None else
                                  {k: v[i] for k, v in arrays.items()},
                                  self.device)
            if self.mesh is not None and denoms is None:
                denoms = _global_denoms(
                    loss_counts(batch, self.cfg, self.dec_pad_id), self.mesh)
            with span("train.micro"):
                self._micro(batch, denoms)
            return
        with span("train.stage"):
            key.load(arrays, i)
        key.micro(lambda: self._micro(key.inputs, None))

    def _finish(self, state: TrainState) -> Dict[str, Tensor]:
        self.optimizer.prepare()
        if self.route == CUDA_GRAPHS:
            self.graphs.update(self._update)
        else:
            with span("train.update"):
                self._update()
        self.optimizer.advance()
        state.step += 1
        out = {k: v.clone() for k, v in self.outputs.items()}
        out["grad_norm"] = self.optimizer.grad_norm.clone()
        return out


class _SingleStep(TrainStep):
    """One batch: the micro-batch part's backward writes the gradients and
    the metrics into their buffers."""

    def _micro(self, batch, denoms) -> None:
        loss, metrics = self.loss_fn(batch, self.gen, denoms)
        loss.backward()
        for name, value in metrics.items():
            self._output(name).copy_(value.detach())

    @torch.no_grad()
    def _update(self) -> None:
        if self.mesh is not None:   # each the sum of the dp ranks' terms
            total = _all_reduce(torch.stack(list(self.outputs.values())),
                                self.mesh)
            torch._foreach_copy_(list(self.outputs.values()),
                                 list(total.unbind()))
        self.optimizer.apply()

    def __call__(self, state: TrainState, batch: Mapping[str, Any],
                 seed: int) -> Tuple[TrainState, Dict[str, Tensor]]:
        with span("train.step"):
            arrays = getattr(batch, "arrays", batch)
            key = self._begin(arrays, stacked=False)
            self._micro_batch(key, arrays, None, None, state.step, seed)
            return state, self._finish(state)


class _AccumStep(TrainStep):
    """Micro-batches: the micro-batch part accumulates the backward of
    `loss * w` and `loss_sum += w * loss`; the update part divides both by
    the weight sum. The weight and the weight sum are device scalars that
    the host writes before each part."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        scalar = lambda: torch.zeros((), device=self.device)  # noqa: E731
        self.loss_sum, self.w, self.denom = scalar(), scalar(), scalar()

    def _micro(self, batch, denoms) -> None:
        loss, _ = self.loss_fn(batch, self.gen, denoms)
        (loss * self.w).backward()
        self.loss_sum += loss.detach() * self.w

    @torch.no_grad()
    def _update(self) -> None:
        loss_sum = (self.loss_sum if self.mesh is None
                    else _all_reduce(self.loss_sum, self.mesh))
        self._output("train_loss").copy_(loss_sum / self.denom)
        self.loss_sum.zero_()
        torch._foreach_div_(self.optimizer.ensure_grads(), self.denom)
        self.optimizer.apply()

    def __call__(self, state: TrainState, microbatches: Mapping[str, Any],
                 mb_weights: Sequence[float], seed: int
                 ) -> Tuple[TrainState, Dict[str, Tensor]]:
        with span("train.step"):
            arrays = getattr(microbatches, "arrays", microbatches)
            weights = [float(w)
                       for w in np.asarray(mb_weights, dtype=np.float32)]
            key = self._begin(arrays, stacked=True)
            denoms = [None] * len(weights)
            if self.mesh is not None:
                counts = torch.stack([
                    loss_counts({k: v[i] for k, v in arrays.items()},
                                self.cfg, self.dec_pad_id)
                    for i in range(len(weights))])
                denoms = _global_denoms(counts.to(self.device),
                                        self.mesh).unbind()
            for i, w in enumerate(weights):
                if w == 0.0:
                    continue
                self.w.fill_(w)
                self._micro_batch(key, arrays, i, denoms[i],
                                  state.step * 1009 + i, seed)
            self.denom.fill_(max(sum(weights), 1.0))
            return state, self._finish(state)


def make_train_step(module: torch.nn.Module, cfg, optimizer: Optimizer,
                    dec_pad_id: int, device=None) -> TrainStep:
    """train_step(state, batch, seed) -> (state, metrics). Metrics are
    0-dim tensors on the device (`train_loss`, with MLM `mlm_loss` and
    `total_loss`, and `grad_norm`, the global norm before the clip).
    `train_step.route` says how it runs (`TrainStep`)."""
    return _SingleStep(module, cfg, optimizer, dec_pad_id, device)


def make_accum_train_step(module: torch.nn.Module, cfg, optimizer: Optimizer,
                          dec_pad_id: int, device=None) -> TrainStep:
    """Gradient accumulation over the leading micro-batch axis (reference
    accumulate_grad_batches, main.py:381).

    train_step(state, microbatches, mb_weights, seed): every array of
    `microbatches` has a leading axis of n micro-batches; `mb_weights` (n,)
    marks real ones with 1.0 and the padding of a trailing partial window
    with 0.0. Gradients and loss average over the weight sum. A weight-0
    micro-batch contributes 0 * its gradient, so it is not run at all.
    On a mesh every micro-batch's loss divides by its global counts (one
    all-reduce of all the counts before the first forward), and the dp
    ranks must hold the same weights. `train_step.route` says how it runs
    (`TrainStep`)."""
    return _AccumStep(module, cfg, optimizer, dec_pad_id, device)


def eval_route(module: torch.nn.Module, device: torch.device) -> str:
    """The route of an eval step of `module` on `device`: graphs on a card,
    unless the forward holds a collective (a mesh, as `train_route`).
    Remat does not bar them: `remat_block` runs only in training mode with
    gradients on (models/encoder.py, models/decoder.py), and the eval step
    runs in eval mode under `torch.no_grad`, so its forward sets no
    generator state on the host."""
    return (CUDA_GRAPHS if device.type == "cuda" and _dp(module) is None
            else UNCAPTURED)


class EvalStep:
    """Per-example val scores (reference validation_step, main.py:177-188):
    acc = greedy exact match, loss = per-example mean CE; the port's
    counterpart of the JAX eval step's one `jax.jit` program.

    Template-based models return the top-`edit_topk` edit candidates ranked
    on the device (`device_topk_edits` over the flattened atom and bond
    probabilities) instead of the full (B, A, n_a+1) / (B, MB, n_b+1)
    probability tensors: the host merges two k-long lists per example
    (edits_from_topk), where the reference argsorts the full grids on the
    host (utils.py:79-108).

    `route` is chosen once (`eval_route`). On "cuda_graphs" each shape key
    has static inputs, a graph of the forward (run once uncaptured at the
    key's first call, then captured and replayed) and output buffers
    outside the graph pool (train/graphs.py `EvalGraphs`): a call copies
    the batch into its key's inputs, replays, and returns clones of the
    outputs, so a result stays as it was across later calls. Nothing waits
    for the card: the caller's read of a result is the one wait. On
    "uncaptured" the forward runs as it is; setting `route` to it on a card
    gives the reference the graphs are held to."""

    def __init__(self, module: torch.nn.Module, cfg, dec_pad_id: int,
                 edit_topk: int = 500, device=None):
        self.device = _check_device(module, device)
        self.module, self.dec_pad_id = module, dec_pad_id
        self.template_based = cfg.template_based
        self.edit_topk = edit_topk
        self.route = eval_route(module, self.device)
        self.graphs: Optional[EvalGraphs] = None   # at the first call

    def _forward(self, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        out = self.module(**_model_inputs(batch, self.template_based, None))
        if self.template_based:
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
                bond_labels != losses.IGNORE_INDEX, self.edit_topk)
            return res
        return {
            "example_mask": batch["example_mask"],
            "indices": batch["indices"],
            "loss": losses.seq2seq_loss(
                out["logits"], batch["decoder_input_ids"], self.dec_pad_id,
                reduction="none"),
            "acc": losses.seq2seq_greedy_acc(
                out["logits"], batch["decoder_input_ids"], self.dec_pad_id),
        }

    @torch.no_grad()
    def __call__(self, batch: Mapping[str, Any]) -> Dict[str, Tensor]:
        self.module.eval()
        if self.route != CUDA_GRAPHS:
            batch = to_device(batch, self.device)
            with span("eval.forward"):
                return self._forward(batch)
        arrays = getattr(batch, "arrays", batch)
        if self.graphs is None:
            self.graphs = EvalGraphs(self.device)
        key = self.graphs.key(arrays)
        key.load(arrays, None)
        key.forward(lambda: key.store(self._forward(key.inputs)))
        return {name: out.clone() for name, out in key.outputs.items()}


def make_eval_step(module: torch.nn.Module, cfg, dec_pad_id: int,
                   edit_topk: int = 500, device=None) -> EvalStep:
    """eval_step(batch) -> per-example scores, tensors on the device
    (`EvalStep`); `eval_step.route` says how it runs."""
    return EvalStep(module, cfg, dec_pad_id, edit_topk, device)
