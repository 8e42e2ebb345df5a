"""Optimizer + LR schedule (twin of textreact_tpu/train/optim.py).

Parity: reference main.py:270-276: AdamW with weight decay on every
parameter (biases and LayerNorm included, as `optax.adamw` and torch's
default do), HF get_scheduler 'cosine' / 'constant' warmup schedules
stepped per optimizer step, plus global-norm gradient clipping (Trainer
gradient_clip_val, main.py:380).

Two places where the obvious torch call is not the JAX package's function:
- `optax.clip_by_global_norm` scales by max_norm / max(norm, max_norm), with
  no epsilon; `torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6. The
  clip here is optax's.
- the schedule is read at the optimizer's step count starting from 0, so
  with a warmup the first update has learning rate 0.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

from ..config import ExperimentConfig
from ..parallel.sharding import (dp_gather, dp_slice, tp_gather, tp_slice,
                                 zero_axis)


def lr_schedule(cfg: ExperimentConfig,
                num_training_steps: int) -> Callable[[int], float]:
    """step (0-based count of updates already made) -> learning rate."""
    warmup = int(num_training_steps * cfg.warmup_ratio)

    if cfg.scheduler == "constant":
        def constant(step: int) -> float:
            if step < warmup:
                return cfg.lr * step / warmup
            return cfg.lr
        return constant

    # HF 'cosine': linear warmup then cosine decay to 0 over the remainder
    def cosine(step: int) -> float:
        if step < warmup:
            return cfg.lr * step / max(1, warmup)
        progress = (step - warmup) / max(1, num_training_steps - warmup)
        progress = min(max(progress, 0.0), 1.0)
        return cfg.lr * 0.5 * (1.0 + math.cos(math.pi * progress))

    return cosine


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in f32, on the device
    (optax.global_norm)."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> None:
    """In place: g *= max_norm / max(norm, max_norm) (optax's rule: exactly
    1 below the threshold, no epsilon). `norm` is global_norm(grads)."""
    scale = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, scale)


class Optimizer:
    """clip_by_global_norm(max_grad_norm) then AdamW(b1 0.9, b2 0.999, eps
    1e-8, weight decay on every parameter) at the scheduled rate: the chain
    `textreact_tpu.train.optim.make_optimizer` builds from optax.

    `update` consumes the `.grad` of the parameters and returns the global
    gradient norm before the clip; `count` is the number of updates made.
    `params` are (name, parameter) pairs, as `named_parameters()` gives
    them; the names key the moments in `state_dict`.

    On a mesh (`mesh`, with a dp group), `update` first all-reduces the
    gradients over the dp group (once per optimizer step), then averages
    the gradients of the parameters that tp does not split (those not in
    `tp_axes`, name -> axis) over the tp group: the tp ranks compute them
    from the same replicated activations, but a kernel that sums by
    atomics (the embedding tables' backward on the card) rounds them apart
    in the last bits, and the replicas would drift apart without a word.
    The norm sums the squares of the tp-split gradients over the tp group
    and counts the replicated ones once. With `zero1` each dp
    rank keeps the moments of its slice of each parameter
    (`parallel.sharding.zero_axis`), updates that slice, and the slices
    are all-gathered over the dp group."""

    def __init__(self, params: Iterable, cfg: ExperimentConfig,
                 num_training_steps: int, mesh=None, zero1: bool = False,
                 tp_axes: Optional[Dict[str, int]] = None):
        named = list(params)
        if not all(isinstance(x, tuple) and len(x) == 2 for x in named):
            raise TypeError("Optimizer takes (name, parameter) pairs: pass "
                            "module.named_parameters()")
        named = [(n, p) for n, p in named if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.schedule = lr_schedule(cfg, num_training_steps)
        self.max_grad_norm = cfg.max_grad_norm
        self.count = 0
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        self.tp_axes = {} if self.mesh is None else dict(tp_axes or {})
        dp = 1 if self.mesh is None else self.mesh.dp_size
        self.zero_axes = [zero_axis(p.shape, dp) if zero1 and self.mesh
                          else None for p in self.params]
        # what AdamW updates: each parameter, or under ZeRO-1 this dp
        # rank's slice of it (a view into the parameter)
        self.shards = [p if axis is None
                       else dp_slice(p.detach(), axis, self.mesh)
                       for p, axis in zip(self.params, self.zero_axes)]
        self.adamw = torch.optim.AdamW(
            self.shards, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _all_reduce(self, names: set, group, parts: int = 1) -> None:
        """Sum the gradients of `names` over `group`, then divide by
        `parts`: one all-reduce a dtype."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for n, p in zip(self.names, self.params):
            if p.grad is not None and n in names:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            if parts > 1:
                flat /= parts
            torch._foreach_copy_(grads, [
                f.view_as(g) for f, g in zip(
                    flat.split([g.numel() for g in grads]), grads)])

    def _norm(self) -> torch.Tensor:
        """The global norm of the whole model's gradient."""
        split = [p.grad for n, p in zip(self.names, self.params)
                 if p.grad is not None and n in self.tp_axes]
        if not split:
            return global_norm([p.grad for p in self.params
                                if p.grad is not None])
        whole = [p.grad for n, p in zip(self.names, self.params)
                 if p.grad is not None and n not in self.tp_axes]
        sq = global_norm(split) ** 2
        dist.all_reduce(sq, group=self.mesh.tp_group)
        return torch.sqrt(global_norm(whole) ** 2 + sq)

    @torch.no_grad()
    def update(self) -> torch.Tensor:
        if self.mesh is not None:
            self._all_reduce(set(self.names), self.mesh.dp_group)
        if self.tp_axes:
            self._all_reduce(set(self.names) - set(self.tp_axes),
                             self.mesh.tp_group, self.mesh.tp_size)
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = self._norm()
        clip_by_global_norm(grads, self.max_grad_norm, norm)
        for p, shard, axis in zip(self.params, self.shards, self.zero_axes):
            if axis is not None:
                shard.grad = (None if p.grad is None
                              else dp_slice(p.grad, axis, self.mesh))
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        for p, shard, axis in zip(self.params, self.shards, self.zero_axes):
            if axis is not None:
                shard.grad = None
                p.copy_(dp_gather(shard, axis, self.mesh))
        self.count += 1
        return norm

    def _full(self, name: str, t: torch.Tensor, axis) -> torch.Tensor:
        """The whole moment of parameter `name` from this rank's piece."""
        if axis is not None:
            t = dp_gather(t, axis, self.mesh)
        if name in self.tp_axes:
            t = tp_gather(t, self.tp_axes[name], self.mesh)
        return t

    def _piece(self, name: str, t: torch.Tensor, axis) -> torch.Tensor:
        """This rank's piece of the whole moment `t` of parameter `name`."""
        if name in self.tp_axes:
            t = tp_slice(t, self.tp_axes[name], self.mesh)
        if axis is not None:
            t = dp_slice(t, axis, self.mesh)
        return t.clone()

    def state_dict(self) -> Dict:
        """The update count and each parameter's moments, whole: gathered
        over the dp group under ZeRO-1 and over the tp group for tp-split
        parameters, so that the state fits any mesh (a collective on a
        mesh: every rank calls it)."""
        moments = {}
        for name, shard, axis in zip(self.names, self.shards,
                                     self.zero_axes):
            st = self.adamw.state.get(shard)
            if not st:
                continue
            moments[name] = {
                "step": st["step"],
                "exp_avg": self._full(name, st["exp_avg"], axis),
                "exp_avg_sq": self._full(name, st["exp_avg_sq"], axis)}
        return {"count": self.count, "moments": moments}

    def load_state_dict(self, state: Dict) -> None:
        """Take this rank's pieces of the whole moments of `state_dict`.
        Raises if the state holds moments of a parameter this optimizer
        does not have, or of another shape; a parameter without saved
        moments (no gradient reached it yet) starts without them."""
        unknown = sorted(set(state["moments"]) - set(self.names))
        if unknown:
            raise KeyError(f"Optimizer.load_state_dict: moments of "
                           f"parameters this optimizer does not hold: "
                           f"{unknown[:5]}")
        pieces = {}
        for name, shard, axis in zip(self.names, self.shards,
                                     self.zero_axes):
            m = state["moments"].get(name)
            if m is None:
                continue
            avg, avg_sq = (self._piece(name, m[key], axis).to(shard.device)
                           for key in ("exp_avg", "exp_avg_sq"))
            if avg.shape != shard.shape or avg_sq.shape != shard.shape:
                raise ValueError(f"Optimizer.load_state_dict: moments of "
                                 f"{name} have shape {tuple(avg.shape)}, "
                                 f"its piece {tuple(shard.shape)}")
            # AdamW keeps its step counts on the host
            pieces[shard] = {
                "step": torch.as_tensor(m["step"]).detach().to("cpu").clone(),
                "exp_avg": avg, "exp_avg_sq": avg_sq}
        self.adamw.state.update(pieces)
        self.count = state["count"]


def make_optimizer(cfg: ExperimentConfig, num_training_steps: int,
                   params: Iterable, mesh=None,
                   tp_axes: Optional[Dict[str, int]] = None) -> Optimizer:
    """The optimizer of `params` ((name, parameter) pairs); on a mesh with
    ZeRO-1 when cfg.zero1."""
    return Optimizer(params, cfg, num_training_steps, mesh=mesh,
                     zero1=cfg.zero1, tp_axes=tp_axes)
