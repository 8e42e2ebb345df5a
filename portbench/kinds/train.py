"""Training cells: the recipe's optimizer step, the port's
`make_accum_train_step` on the graphed route, over a pool of steps cycled.

Set-up builds one train step with its model and optimizer state, loads the
benchmark's weights, and runs one step of each shape key the pool yields
through the window's own call, which captures that key's graphs. It then
puts the seed's weights back and zeroes the optimizer's moments, count and
step, in place (the graphs read those buffers), and runs the first
`checked_steps` of the pool, each a replay of captured graphs: these are
the steps the reference follows. The same object then runs the window. A
window keeps at most two steps queued ahead of the card, as a trainer that
reads its losses a step late does.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .. import check, flops, program, traffic, weights
from ..reference import encdec

IN_FLIGHT = 2


class Cell:
    unit = "steps"

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
        from textreact_tpu_torch.train import (TrainState,
                                               make_accum_train_step,
                                               make_optimizer)
        self.exp = program.experiment(cfg, ctx.config_name, "train", ctx.seed)
        self.module, _, _ = program.build(cfg, self.exp, dev)
        self.spec = weights.specs(cfg["encoder"], cfg["decoder"], mlm=True)
        self.optimizer = make_optimizer(self.exp, cfg["num_training_steps"],
                                        self.module.named_parameters())
        self.step = make_accum_train_step(self.module, self.exp,
                                          self.optimizer,
                                          cfg["decoder_ids"]["pad"],
                                          device=dev)
        if dev.type == "cuda" and self.step.route != "cuda_graphs":
            raise RuntimeError(f"the train step runs {self.step.route!r} on "
                               "the card, not its graphed route")
        self.state = TrainState.create(self.module, self.optimizer)
        self.pool = traffic.train_pool(mix, cfg, ctx.seed)
        self.weights_mb = [1.0] * mix["micro_batches"]
        self.examples = mix["micro_batches"] * mix["micro_batch_size"]
        self.done = 0
        self.events: List[torch.cuda.Event] = []
        self._capture_keys()
        self._restore()
        replays = self._replays()
        checked = mix["checked_steps"]
        self.losses = []
        for i in range(checked):
            out = self.run_unit()
            self.losses.append(out["train_loss"])
            if i == 0:
                self.first_grad = self._host(dict(zip(
                    self.optimizer.names, self.optimizer.exp_avg)))
        self.after = self._host(dict(self.module.named_parameters()))
        self.sync()
        self.losses = [float(x) for x in self.losses]
        if replays is not None and self._replays() != (
                replays[0] + checked * mix["micro_batches"],
                replays[1] + checked):
            raise RuntimeError("the checked steps were not all replays of "
                               "captured graphs")

    def _capture_keys(self) -> None:
        """One step of each shape key the pool yields: a key's first call
        runs it and captures its graphs."""
        seen = set()
        for arrays in self.pool:
            key = tuple(sorted((k, v.shape) for k, v in arrays.items()))
            if key not in seen:
                seen.add(key)
                self.state, _ = self.step(self.state, arrays, self.weights_mb,
                                          self.ctx.seed)
        self.sync()

    def _restore(self) -> None:
        """The seed's weights, zero moments, count and step, copied into
        the buffers the graphs read."""
        weights.load_into(self.module, self._weights())
        self.optimizer.load_state_dict({"count": 0, "moments": {}})
        self.state.step = 0
        self.done = 0

    def _replays(self):
        """(micro-batch replays, update replays) so far, on the card."""
        graphs = getattr(self.step, "graphs", None)
        if self.ctx.device.type != "cuda" or graphs is None:
            return None
        return (sum(part.micro.replays for part in graphs.keys.values()),
                graphs.update.replays)

    def _weights(self, dtype=None):
        cfg = self.ctx.cfg
        return weights.make(self.spec, self.ctx.seed,
                            cfg["encoder"]["initializer_range"],
                            dtype or program.dtype(cfg["param_dtype"]),
                            self.ctx.device)

    @staticmethod
    def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for name, t in tensors.items():
            h = torch.empty(t.shape, dtype=t.dtype,
                            pin_memory=t.is_cuda)
            h.copy_(t.detach(), non_blocking=True)
            out[name] = h
        return out

    # --- the window's work ---------------------------------------------
    def run_unit(self):
        arrays = self.pool[self.done % len(self.pool)]
        self.state, out = self.step(self.state, arrays, self.weights_mb,
                                    self.ctx.seed)
        self.done += 1
        if self.ctx.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self.events.append(ev)
            if len(self.events) > IN_FLIGHT:
                self.events.pop(0).synchronize()
        return out

    def sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        self.events.clear()

    def end_to_end(self, units: int, window_s: float) -> Dict[str, tuple]:
        return {"train_examples_per_s":
                (units * self.examples / window_s, "examples/s")}

    def slice_facts(self, first: int, count: int) -> dict:
        """What the metric readers need of `count` units from unit `first`
        (as `done` counts them, from the first checked step): model FLOPs
        and the fused kernels' bound seconds."""
        cfg, enc = self.ctx.cfg, self.ctx.cfg["encoder"]
        H = enc["num_attention_heads"]
        D = enc["hidden_size"] // H
        model_flops = attn = ln = 0.0
        for u in range(first, first + count):
            step = self.pool[u % len(self.pool)]
            model_flops += flops.train_step_flops(step, enc, cfg["decoder"])
            for mb in range(step["input_ids"].shape[0]):
                mask = step["attention_mask"][mb]
                b = flops.attention_bounds(mask, H, D)
                attn += enc["num_hidden_layers"] * (b["fwd"] + b["bwd"])
                B, L = mask.shape
                Ld = step["decoder_input_ids"].shape[-1]
                for rows, calls in (
                        (B * L, 2 * enc["num_hidden_layers"]),
                        (B * Ld, 3 * cfg["decoder"]["num_hidden_layers"])):
                    b = flops.layernorm_bounds(rows, enc["hidden_size"])
                    ln += calls * (b["fwd"] + b["bwd"])
        return {"model_flops": model_flops,
                "bound_s": {"attention": attn, "layernorm": ln}}

    # --- correctness -----------------------------------------------------
    def free(self) -> None:
        del self.step, self.optimizer, self.state, self.module
        self.events.clear()

    def check(self) -> Dict[str, tuple]:
        """The program's first steps beside the reference's."""
        return self.compare(run_reference(
            self.ctx, self.pool, self._weights(torch.float32), "f32"))

    def compare(self, ref: dict) -> Dict[str, tuple]:
        dev = self.ctx.device
        init = self._weights(torch.float32)
        delta = {n: self.after[n].to(dev).double() - init[n].double()
                 for n in init}
        b1 = 0.9
        grad = {n: g.to(dev).double() / (1.0 - b1)
                for n, g in self.first_grad.items()}
        return check.train_numbers(
            self.losses, ref["losses"], check.leaf_norms(grad),
            ref["grad_norms"], check.leaf_norms(delta), ref["delta_norms"])


def _tensors(arrays: Dict[str, np.ndarray], i: int, device,
             rows=None) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in arrays.items():
        x = v[i] if rows is None else v[i][rows]
        out[k] = torch.as_tensor(np.ascontiguousarray(x), dtype=torch.long,
                                 device=device)
    return out


def run_reference(ctx, pool, params: Dict[str, torch.Tensor],
                  precision: str, half_batch: bool = False) -> dict:
    """The configuration's first `checked_steps` steps in the plain
    reference, from `params` (float32), over the same micro-batches and
    dropout masks: each step's loss, the first step's clipped gradient
    norms by leaf and the change of every leaf after the steps.
    `half_batch` runs each micro-batch on its first half of rows (a fault
    that the check must catch)."""
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    encdec.strict_f32()
    init = {n: p.detach().clone() for n, p in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    model = encdec.EncDec(params, cfg["encoder"], cfg["decoder"],
                          encdec.Products(precision))
    names = list(params)
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    gen = torch.Generator(device=dev)
    losses, grad_norms = [], {}
    b1, b2, eps = 0.9, 0.999, 1e-8
    n_micro = mix["micro_batches"]
    rows = (slice(0, mix["micro_batch_size"] // 2) if half_batch else None)
    for s in range(mix["checked_steps"]):
        total = 0.0
        for i in range(n_micro):
            gen.manual_seed(encdec.dropout_seed(ctx.seed, s * 1009 + i))
            draws = encdec.Draws(gen, kernels=dev.type == "cuda")
            batch = _tensors(pool[s], i, dev, rows)
            loss = encdec.train_loss(model, batch, cfg["mlm_lambda"],
                                     cfg["decoder_ids"]["pad"], draws)
            loss.backward()
            total += float(loss.detach())
        losses.append(total / n_micro)
        with torch.no_grad():
            grads = {n: params[n].grad / n_micro for n in names}
            norm = math.sqrt(sum(float(g.double().pow(2).sum())
                                 for g in grads.values()))
            scale = cfg["max_grad_norm"] / max(norm, cfg["max_grad_norm"])
            lr = _rate(cfg, s)
            for n in names:
                g = grads[n] * scale
                if s == 0:
                    grad_norms[n] = float(torch.linalg.vector_norm(
                        g.double()))
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m[n] / (1 - b1 ** (s + 1))) / (
                    (v[n] / (1 - b2 ** (s + 1))).sqrt() + eps)
                u = u + cfg["weight_decay"] * params[n]
                params[n].sub_(lr * u)
                params[n].grad = None
    delta = {n: float(torch.linalg.vector_norm(
        (params[n].detach() - init[n]).double())) for n in names}
    return {"losses": losses, "grad_norms": grad_norms,
            "delta_norms": delta}


def _rate(cfg: dict, step: int) -> float:
    """The learning rate of update `step` (0-based): linear warmup, then
    the cosine decay to 0 over num_training_steps (HF's 'cosine')."""
    total = cfg["num_training_steps"]
    warm = int(total * cfg["warmup_ratio"])
    if step < warm:
        return cfg["lr"] * step / max(1, warm)
    if cfg["scheduler"] == "constant":
        return cfg["lr"]
    progress = min(max((step - warm) / max(1, total - warm), 0.0), 1.0)
    return cfg["lr"] * 0.5 * (1.0 + math.cos(math.pi * progress))
