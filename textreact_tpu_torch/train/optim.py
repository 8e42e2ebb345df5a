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
    `textreact_tpu.train.optim.make_optimizer` builds from optax, written
    with `torch._foreach_*` ops in optax's order of operations.

    `update` consumes the `.grad` of the parameters, leaves them zeroed in
    place, and returns the global gradient norm before the clip; `count` is
    the number of updates made. `params` are (name, parameter) pairs, as
    `named_parameters()` gives them; the names key the moments in
    `state_dict`.

    Everything the update reads or writes on the device lies in buffers
    allocated once, here or at the first `ensure_grads`: the gradients
    (`.grad`, accumulated in place by the backward), the moments, the
    update count and the learning rate as 0-d tensors, and the norm. So
    `apply`, the device half of `update`, can be captured in a CUDA graph
    (train/graphs.py) and replayed; `prepare` before it writes the host
    schedule's rate into the rate tensor, and `advance` after it counts the
    update on the host. `update` is the three in a row. The same code runs
    on the CPU and on the card. A parameter whose gradient never arrives
    is updated with a zero gradient, as optax updates every leaf.

    On a mesh (`mesh`, with a dp group), `apply` first all-reduces the
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

    B1, B2, EPS = 0.9, 0.999, 1e-8

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
        self.weight_decay = cfg.weight_decay
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
        # the device state, allocated at first use where the parameters
        # then lie (`_allocate`): the moments, and as 0-d tensors the
        # update count (optax's), the rate and the norm
        self.exp_avg: List[torch.Tensor] = []
        self.exp_avg_sq: List[torch.Tensor] = []
        self.count_t = self.lr = self.grad_norm = None

    @torch.no_grad()
    def _allocate(self) -> None:
        if self.count_t is not None:
            return
        self.exp_avg = [torch.zeros_like(s) for s in self.shards]
        self.exp_avg_sq = [torch.zeros_like(s) for s in self.shards]
        device = self.params[0].device
        self.count_t, self.lr, self.grad_norm = (
            torch.full((), float(self.count), device=device),
            torch.zeros((), device=device), torch.zeros((), device=device))

    def ensure_grads(self) -> List[torch.Tensor]:
        """The gradient buffers, allocated (zeroed) where `.grad` is None;
        the backward accumulates into them in place."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def zero_grad(self) -> None:
        """Zero the gradients in place (their buffers stay)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if grads:
            torch._foreach_zero_(grads)

    def _all_reduce(self, names: set, group, parts: int = 1) -> None:
        """Sum the gradients of `names` over `group`, then divide by
        `parts`: one all-reduce a dtype."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for n, p in zip(self.names, self.params):
            if n in names:
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
                 if n in self.tp_axes]
        if not split:
            return global_norm([p.grad for p in self.params])
        whole = [p.grad for n, p in zip(self.names, self.params)
                 if n not in self.tp_axes]
        sq = global_norm(split) ** 2
        dist.all_reduce(sq, group=self.mesh.tp_group)
        return torch.sqrt(global_norm(whole) ** 2 + sq)

    def prepare(self) -> None:
        """Host half, before `apply`: the schedule's rate of this update
        (read at the count of updates already made) into `lr`."""
        self._allocate()
        self.lr.fill_(self.schedule(self.count))

    @torch.no_grad()
    def apply(self) -> torch.Tensor:
        """Device half: all-reduce on a mesh, norm, clip, AdamW, the device
        count, the gradients zeroed. Returns `grad_norm` (a buffer that the
        next update overwrites)."""
        self._allocate()
        grads = self.ensure_grads()
        if self.mesh is not None:
            self._all_reduce(set(self.names), self.mesh.dp_group)
        if self.tp_axes:
            self._all_reduce(set(self.names) - set(self.tp_axes),
                             self.mesh.tp_group, self.mesh.tp_size)
        norm = self._norm()
        self.grad_norm.copy_(norm)
        clip_by_global_norm(grads, self.max_grad_norm, norm)
        g = [grad if axis is None else dp_slice(grad, axis, self.mesh)
             for grad, axis in zip(grads, self.zero_axes)]
        m, v, p = self.exp_avg, self.exp_avg_sq, self.shards
        b1, b2 = self.B1, self.B2
        # optax.scale_by_adam: m = (1 - b1) g + b1 m, v = (1 - b2) g^2 + b2 v
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(g, g), 1.0 - b2))
        self.count_t += 1
        # u = (m / (1 - b1^n)) / (sqrt(v / (1 - b2^n)) + eps)
        u = torch._foreach_div(m, 1.0 - torch.pow(b1, self.count_t))
        den = torch._foreach_div(v, 1.0 - torch.pow(b2, self.count_t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.EPS)
        torch._foreach_div_(u, den)
        del den
        # optax.add_decayed_weights, then the rate: p = p - lr (u + wd p)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(u, self.lr)
        torch._foreach_sub_(p, u)
        for param, shard, axis in zip(self.params, self.shards,
                                      self.zero_axes):
            if axis is not None:
                param.copy_(dp_gather(shard, axis, self.mesh))
        torch._foreach_zero_(grads)
        return self.grad_norm

    def advance(self) -> None:
        """Host half, after `apply`: count the update."""
        self.count += 1

    def update(self) -> torch.Tensor:
        """One update: `prepare`, `apply`, `advance`. Returns the global
        gradient norm before the clip (a new tensor)."""
        self.prepare()
        norm = self.apply().clone()
        self.advance()
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
        return t

    def state_dict(self) -> Dict:
        """The update count and each parameter's moments, whole: gathered
        over the dp group under ZeRO-1 and over the tp group for tp-split
        parameters, so that the state fits any mesh (a collective on a
        mesh: every rank calls it). The format of `torch.optim.AdamW`'s
        state, which this optimizer's earlier version kept: per parameter
        `step` (a host float tensor, here always `count`), `exp_avg`,
        `exp_avg_sq`; no moments before the first update."""
        moments = {}
        if self.count:
            self._allocate()
            for name, axis, avg, avg_sq in zip(self.names, self.zero_axes,
                                               self.exp_avg, self.exp_avg_sq):
                moments[name] = {
                    "step": torch.tensor(float(self.count)),
                    "exp_avg": self._full(name, avg, axis),
                    "exp_avg_sq": self._full(name, avg_sq, axis)}
        return {"count": self.count, "moments": moments}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Take this rank's pieces of the whole moments of `state_dict`,
        copied into the moment buffers in place (graphs captured before
        stay valid). A parameter without saved moments starts from zero
        ones. Raises, leaving the state as it was, if the state holds
        moments of a parameter this optimizer does not have, of another
        shape, or counted at another step than the state's `count` (the
        update count is one for all parameters, as optax's)."""
        unknown = sorted(set(state["moments"]) - set(self.names))
        if unknown:
            raise KeyError(f"Optimizer.load_state_dict: moments of "
                           f"parameters this optimizer does not hold: "
                           f"{unknown[:5]}")
        count = int(state["count"])
        pieces = []
        for name, shard, axis in zip(self.names, self.shards,
                                     self.zero_axes):
            m = state["moments"].get(name)
            if m is None:
                pieces.append(None)
                continue
            avg, avg_sq = (self._piece(name, m[key], axis)
                           for key in ("exp_avg", "exp_avg_sq"))
            if avg.shape != shard.shape or avg_sq.shape != shard.shape:
                raise ValueError(f"Optimizer.load_state_dict: moments of "
                                 f"{name} have shape {tuple(avg.shape)}, "
                                 f"its piece {tuple(shard.shape)}")
            step = float(torch.as_tensor(m["step"]))
            if step != count:
                raise ValueError(f"Optimizer.load_state_dict: moments of "
                                 f"{name} at step {step:g}, the state's "
                                 f"count is {count}")
            pieces.append((avg, avg_sq))
        self._allocate()
        for piece, avg, avg_sq in zip(pieces, self.exp_avg, self.exp_avg_sq):
            if piece is None:
                avg.zero_()
                avg_sq.zero_()
            else:
                avg.copy_(piece[0])
                avg_sq.copy_(piece[1])
        self.count = count
        self.count_t.fill_(count)


def make_optimizer(cfg: ExperimentConfig, num_training_steps: int,
                   params: Iterable, mesh=None,
                   tp_axes: Optional[Dict[str, int]] = None) -> Optimizer:
    """The optimizer of `params` ((name, parameter) pairs); on a mesh with
    ZeRO-1 when cfg.zero1."""
    return Optimizer(params, cfg, num_training_steps, mesh=mesh,
                     zero1=cfg.zero1, tp_axes=tp_axes)
