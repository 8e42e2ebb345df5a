"""The train step's capturable optimizer and routes, on the CPU.

The optimizer that the step's update part runs (`train/optim.py`, written
with `torch._foreach_*` ops so that a CUDA graph can hold it) against the
optax chain of the JAX package over three updates, a warmup's first update
at rate 0 and the clip biting; a checkpoint in the format the optimizer
had before (a `torch.optim.AdamW` state, its step counts on the host)
restored and continued against an unbroken run; a restore that keeps the
buffers a captured graph reads; and the route each train step chooses
where no graph can run: on the CPU, on a mesh, under remat. The graphed
route itself needs a card: tests/test_torch_cuda_graphs.py.
"""

import _torch_threads  # noqa: F401  (before torch runs)
import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import textreact_tpu.config as jax_config
import textreact_tpu.train.optim as jax_optim
from textreact_tpu_torch.config import ExperimentConfig
from textreact_tpu_torch.models import EncoderDecoder, TransformerConfig
from textreact_tpu_torch.parallel.mesh import make_mesh
from textreact_tpu_torch.parallel.sharding import shard_params
from textreact_tpu_torch.train import (make_accum_train_step, make_optimizer,
                                       make_train_step, optim)
from textreact_tpu_torch.train.step import (CUDA_GRAPHS, UNCAPTURED,
                                            train_route)

# test_torch_train.py's: f32 on both sides
RTOL, ATOL = 1e-5, 2e-5
SHAPES = {"w": (6, 5), "b": (5,), "ln": (3, 2, 4)}
# lr 1e-2, 4 updates with a warmup of 1 (update 0 at rate 0), clip 1.0
EXPERIMENT = dict(lr=1e-2, weight_decay=0.01, max_grad_norm=1.0,
                  scheduler="cosine", warmup_ratio=0.25)
NUM_STEPS = 4


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}


def _grads(step):
    """Gradients of norm ~8-10: the clip at 1.0 bites at every update."""
    rng = np.random.default_rng(100 + step)
    return {n: 3.0 * rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}


def _torch_params(values):
    return [(n, torch.nn.Parameter(torch.from_numpy(v.copy())))
            for n, v in values.items()]


def _step(opt, named, step):
    """Update `step`: its gradients written into the `.grad` buffers."""
    for (_, p), g in zip(named, _grads(step).values()):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        p.grad.copy_(torch.from_numpy(g))
    return opt.update()


def test_optimizer_matches_the_optax_chain_over_three_updates():
    cfg = ExperimentConfig(**EXPERIMENT)
    tx = jax_optim.make_optimizer(jax_config.ExperimentConfig(**EXPERIMENT),
                                  NUM_STEPS)
    values = _params()
    jparams = {n: jnp.asarray(v) for n, v in values.items()}
    jstate = tx.init(jparams)
    named = _torch_params(values)
    opt = make_optimizer(cfg, NUM_STEPS, named)
    for step in range(3):
        grads = {n: jnp.asarray(g) for n, g in _grads(step).items()}
        norm = _step(opt, named, step)
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(grads)),
                                   rtol=RTOL)
        assert float(norm) > cfg.max_grad_norm   # the clip bites
        updates, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in named:
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[n]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{n} {step}")
            if step == 0:   # the warmup's first update moves nothing
                np.testing.assert_array_equal(p.detach().numpy(), values[n])
        # the moments: optax's ScaleByAdamState (mu, nu) after the clip
        adam = jstate[1][0]
        assert int(adam.count) == opt.count == step + 1
        for i, n in enumerate(SHAPES):
            np.testing.assert_allclose(opt.exp_avg[i].numpy(),
                                       np.asarray(adam.mu[n]), rtol=RTOL,
                                       atol=1e-7)
            np.testing.assert_allclose(opt.exp_avg_sq[i].numpy(),
                                       np.asarray(adam.nu[n]), rtol=RTOL,
                                       atol=1e-9)
        # the update leaves the gradients zeroed in their buffers
        assert all(not p.grad.any() for _, p in named)


class _EarlierOptimizer:
    """The optimizer as it was before its update could be captured: optax's
    clip in place, then `torch.optim.AdamW.step()` at the schedule's rate
    written into its param group, its step counts on the host; its
    `state_dict` in the format the checkpoints kept."""

    def __init__(self, cfg, named):
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.schedule = optim.lr_schedule(cfg, NUM_STEPS)
        self.max_grad_norm = cfg.max_grad_norm
        self.count = 0
        self.adamw = torch.optim.AdamW(self.params, lr=self.schedule(0),
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=cfg.weight_decay)

    @torch.no_grad()
    def update(self):
        grads = [p.grad for p in self.params]
        norm = optim.global_norm(grads)
        optim.clip_by_global_norm(grads, self.max_grad_norm, norm)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        return norm

    def state_dict(self):
        return {"count": self.count, "moments": {
            n: {"step": st["step"], "exp_avg": st["exp_avg"],
                "exp_avg_sq": st["exp_avg_sq"]}
            for n, p in zip(self.names, self.params)
            for st in [self.adamw.state[p]]}}


def test_a_checkpoint_of_the_earlier_format_restores_and_continues():
    """Two updates by the earlier optimizer, its state (host step counts)
    into the new one, two more: equal to the earlier optimizer's unbroken
    run of four at the tolerances of test_torch_train.py, and equal to the
    bit to the new optimizer restored from its own state instead."""
    cfg = ExperimentConfig(**EXPERIMENT)
    runs = {}
    for name in ("earlier", "restored", "own"):
        named = _torch_params(_params())
        first = _EarlierOptimizer(cfg, named) if name != "own" else \
            make_optimizer(cfg, NUM_STEPS, named)
        for step in range(2):
            _step(first, named, step)
        state = first.state_dict()
        if name == "earlier":
            opt = first
        else:
            if name == "restored":
                st = next(iter(state["moments"].values()))["step"]
                assert st.device.type == "cpu" and float(st) == 2.0
            opt = make_optimizer(cfg, NUM_STEPS, named)
            opt.load_state_dict(state)
        for step in range(2, 4):
            _step(opt, named, step)
        runs[name] = [p.detach().clone() for _, p in named]
        assert opt.count == 4
    # the unbroken run of the new optimizer
    named = _torch_params(_params())
    opt = make_optimizer(cfg, NUM_STEPS, named)
    for step in range(4):
        _step(opt, named, step)
    unbroken = [p.detach() for _, p in named]
    for got, want, own, whole in zip(runs["restored"], runs["earlier"],
                                     runs["own"], unbroken):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(got, whole, rtol=RTOL, atol=ATOL)
        assert torch.equal(own, whole)


def test_a_restore_keeps_the_buffers_a_graph_reads():
    """`load_state_dict` copies into the moment, count and rate buffers in
    place, and a state without a parameter's moments zeroes them there; a
    state counted at another step than its count is refused, leaving the
    count and the moments as they were."""
    cfg = ExperimentConfig(**EXPERIMENT)
    named = _torch_params(_params())
    opt = make_optimizer(cfg, NUM_STEPS, named)
    _step(opt, named, 0)
    _step(opt, named, 1)
    state = {"count": opt.count, "moments": {
        n: {k: v.clone() for k, v in m.items()}
        for n, m in opt.state_dict()["moments"].items()}}
    buffers = opt.exp_avg + opt.exp_avg_sq + [opt.count_t, opt.lr] + [
        p.grad for _, p in named]
    ptrs = [t.data_ptr() for t in buffers]
    _step(opt, named, 2)
    opt.load_state_dict(state)
    assert [t.data_ptr() for t in buffers] == ptrs
    assert opt.count == 2 and float(opt.count_t) == 2.0
    for i, n in enumerate(SHAPES):
        assert torch.equal(opt.exp_avg[i], state["moments"][n]["exp_avg"])
    del state["moments"]["b"]
    opt.load_state_dict(state)
    assert not opt.exp_avg[1].any() and not opt.exp_avg_sq[1].any()
    assert [t.data_ptr() for t in buffers] == ptrs
    state["moments"]["w"]["step"] = torch.tensor(1.0)
    kept = [t.clone() for t in opt.exp_avg + opt.exp_avg_sq]
    with pytest.raises(ValueError, match="at step 1"):
        opt.load_state_dict(state)
    assert opt.count == 2 and float(opt.count_t) == 2.0
    assert all(torch.equal(t, k) for t, k in
               zip(opt.exp_avg + opt.exp_avg_sq, kept))


# --- routes -----------------------------------------------------------------

def _module(remat=False):
    enc = TransformerConfig(vocab_size=32, hidden_size=64,
                            num_hidden_layers=1, num_attention_heads=2,
                            intermediate_size=128,
                            max_position_embeddings=32)
    dec = dataclasses.replace(enc, is_decoder=True, add_cross_attention=True,
                              bos_token_id=1, eos_token_id=2,
                              pad_token_id=0)
    return EncoderDecoder(enc, dec, dtype=torch.float32, remat=remat)


def _routes(module):
    cfg = ExperimentConfig(**EXPERIMENT)
    opt = make_optimizer(cfg, NUM_STEPS, module.named_parameters())
    return {make(module, cfg, opt, 0, device="cpu").route
            for make in (make_train_step, make_accum_train_step)}


def test_route_is_uncaptured_on_the_cpu_and_under_remat():
    module = _module()
    assert train_route(module, torch.device("cpu")) == UNCAPTURED
    assert _routes(module) == {UNCAPTURED}
    # on a card the plain module takes the graphs, remat does not
    assert train_route(module, torch.device("cuda")) == CUDA_GRAPHS
    remat = _module(remat=True)
    assert train_route(remat, torch.device("cuda")) == UNCAPTURED
    assert _routes(remat) == {UNCAPTURED}


def test_route_is_uncaptured_on_a_one_rank_gloo_mesh(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        assert mesh.distributed
        module = shard_params(mesh, _module())
        assert train_route(module, torch.device("cuda")) == UNCAPTURED
        assert _routes(module) == {UNCAPTURED}
    finally:
        dist.destroy_process_group()
