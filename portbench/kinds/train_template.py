"""Template-based training cells: the RetroSyn_tb recipe's optimizer step,
the port's `build_model` (template branch), `make_optimizer` and
`make_accum_train_step` on the graphed route, over a pool of steps cycled
(`traffic_template.py`).

The set-up, the window and the check are those of `train.py`: one step of
each shape key the pool yields (its graphs captured), the seed's weights
and zero moments copied back in place, then the first `checked_steps` of
the pool, every one a replay, which the plain reference
(`reference/template.py`) follows; at most two steps queued ahead of the
card. The traced slice's facts carry the step's model FLOPs and the
residual LayerNorm kernels' bound (`flops_template.py`), and the program's
count of plain attention calls under a 3-D mask (models/layers.py
`PLAIN_MASK_3D_CALLS`, None in a program without it).
"""

from __future__ import annotations

import json
import math
from typing import Dict, List

import torch

from .. import flops_template, program, traffic_template, weights
from ..reference import encdec, template
from . import train


class Tables:
    """What `build_model` reads of the template tables."""

    def __init__(self, atoms: int, bonds: int):
        self.num_atom_templates, self.num_bond_templates = atoms, bonds


def specs(cfg: dict) -> List[weights.Spec]:
    """Every parameter of the template-based model, in the program's
    naming: the encoder over the joint vocabulary, the three heads, the
    MLM head."""
    enc = dict(cfg["encoder"], vocab_size=cfg["encoder_ids"]["vocab_size"])
    d, f = enc["hidden_size"], enc["intermediate_size"]
    out = weights._embeddings("encoder.embeddings", enc, True)
    for i in range(enc["num_hidden_layers"]):
        out += weights._block(f"encoder.layers.{i}", d, f, cross=False)
    n_a, n_b = cfg["num_atom_templates"] + 1, cfg["num_bond_templates"] + 1
    out += [("head.atom_head.weight", (n_a, d), "matrix"),
            ("head.atom_head.bias", (n_a,), "bias"),
            ("head.bond_head_left.weight", (n_b, d), "matrix"),
            ("head.bond_head_left.bias", (n_b,), "bias"),
            ("head.bond_head_right.weight", (n_b, d), "matrix")]
    out += weights._head("mlm_head", d)
    out += [("mlm_head.decoder.weight", (enc["vocab_size"], d),
             "f32_matrix"),
            ("mlm_head.decoder.bias", (enc["vocab_size"],), "f32_bias")]
    return out


def experiment(cfg: dict, name: str, seed: int):
    """The port's ExperimentConfig of template configuration `cfg`, in
    training; the encoder's sizes in a JSON file under `program.WORK`."""
    from textreact_tpu_torch.config import ExperimentConfig
    program.WORK.mkdir(exist_ok=True)
    path = program.WORK / f"{name}.encoder.json"
    text = json.dumps(cfg["encoder"], indent=1, sort_keys=True)
    if not path.is_file() or path.read_text() != text:
        path.write_text(text)
    return ExperimentConfig(
        task=cfg["task"], seed=seed, template_based=True,
        unattend_nonbonds=cfg["unattend_nonbonds"],
        template_path=str(program.WORK), encoder=str(path),
        encoder_tokenizer="smiles_text", max_length=cfg["max_length"],
        mlm=True, mlm_ratio=cfg["mlm_ratio"], mlm_layer=cfg["mlm_layer"],
        mlm_lambda=cfg["mlm_lambda"], lr=cfg["lr"],
        weight_decay=cfg["weight_decay"], max_grad_norm=cfg["max_grad_norm"],
        scheduler=cfg["scheduler"], warmup_ratio=cfg["warmup_ratio"],
        compute_dtype=cfg["compute_dtype"], param_dtype=cfg["param_dtype"],
        length_buckets=tuple(cfg["length_buckets"]),
        attention_impl="flash", layernorm_impl="fused")


def plain_calls():
    """The program's count of plain attention calls under a 3-D mask; None
    where it keeps none."""
    from textreact_tpu_torch.models import layers
    return getattr(layers, "PLAIN_MASK_3D_CALLS", None)


class Cell(train.Cell):
    unit = "steps"

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
        from textreact_tpu_torch.models import build_model
        from textreact_tpu_torch.train import (TrainState,
                                               make_accum_train_step,
                                               make_optimizer)
        self.exp = experiment(cfg, ctx.config_name, ctx.seed)
        ids = cfg["encoder_ids"]
        self.module, _, _ = build_model(
            self.exp, program.Vocab(ids["vocab_size"], ids["pad"]),
            Tables(cfg["num_atom_templates"], cfg["num_bond_templates"]),
            device=dev)
        self.spec = specs(cfg)
        self.optimizer = make_optimizer(self.exp, cfg["num_training_steps"],
                                        self.module.named_parameters())
        self.step = make_accum_train_step(self.module, self.exp,
                                          self.optimizer, 0, device=dev)
        if dev.type == "cuda" and self.step.route != "cuda_graphs":
            raise RuntimeError(f"the train step runs {self.step.route!r} on "
                               "the card, not its graphed route")
        self.state = TrainState.create(self.module, self.optimizer)
        self.pool = traffic_template.pool(mix, cfg, ctx.seed)
        self.weights_mb = [1.0] * mix["micro_batches"]
        self.examples = mix["micro_batches"] * mix["micro_batch_size"]
        self.done = 0
        self.events: List[torch.cuda.Event] = []
        self.plain_after: Dict[int, int] = {}
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

    def run_unit(self):
        out = super().run_unit()
        self.plain_after[self.done] = plain_calls()
        return out

    def slice_facts(self, first: int, count: int) -> dict:
        """Model FLOPs, the LayerNorm kernels' bound seconds and the plain
        attention calls under a 3-D mask of `count` units from unit
        `first`."""
        cfg = self.ctx.cfg
        model_flops = ln = 0.0
        for u in range(first, first + count):
            step = self.pool[u % len(self.pool)]
            model_flops += flops_template.train_step_flops(step, cfg)
            ln += flops_template.layernorm_bound_s(step, cfg)
        lo, hi = self.plain_after.get(first), self.plain_after.get(
            first + count)
        calls = None if lo is None or hi is None else hi - lo
        return {"model_flops": model_flops, "bound_s": {"layernorm": ln},
                "plain_attention_calls": calls}

    def check(self) -> Dict[str, tuple]:
        return self.compare(run_reference(
            self.ctx, self.pool, self._weights(torch.float32), "f32"))


def run_reference(ctx, pool, params: Dict[str, torch.Tensor],
                  precision: str, half_batch: bool = False,
                  key_mask: bool = False) -> dict:
    """The configuration's first `checked_steps` steps in the plain
    reference, as `train.run_reference` runs the encoder-decoder's: each
    step's loss, the first step's clipped gradient norms by leaf and the
    change of every leaf after the steps. `half_batch` runs each
    micro-batch on its first half of rows; `key_mask` runs it under the
    (B, L) mask of its real keys in place of the bond mask (faults that the
    check must catch)."""
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    encdec.strict_f32()
    init = {n: p.detach().clone() for n, p in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    model = template.TemplateModel(params, cfg["encoder"],
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
            batch = train._tensors(pool[s], i, dev, rows)
            if key_mask:
                batch["attention_mask"] = torch.diagonal(
                    batch["attention_mask"], dim1=1, dim2=2).contiguous()
            loss = template.train_loss(model, batch, cfg["mlm_lambda"],
                                       draws)
            loss.backward()
            total += float(loss.detach())
        losses.append(total / n_micro)
        with torch.no_grad():
            grads = {n: params[n].grad / n_micro for n in names}
            norm = math.sqrt(sum(float(g.double().pow(2).sum())
                                 for g in grads.values()))
            scale = cfg["max_grad_norm"] / max(norm, cfg["max_grad_norm"])
            lr = train._rate(cfg, s)
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
