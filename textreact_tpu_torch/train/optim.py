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
from typing import Callable, Dict, Iterable, List

import torch

from ..config import ExperimentConfig


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
    gradient norm before the clip; `count` is the number of updates made."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: ExperimentConfig, num_training_steps: int):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = lr_schedule(cfg, num_training_steps)
        self.max_grad_norm = cfg.max_grad_norm
        self.count = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def update(self) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = global_norm(grads)
        clip_by_global_norm(grads, self.max_grad_norm, norm)
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1
        return norm

    def state_dict(self) -> Dict:
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.count = state["count"]
        self.adamw.load_state_dict(state["adamw"])


def make_optimizer(cfg: ExperimentConfig, num_training_steps: int,
                   params: Iterable[torch.nn.Parameter]) -> Optimizer:
    return Optimizer(params, cfg, num_training_steps)
