"""Rank bodies of the port's multi-process tests (tests/test_torch_parallel.py,
tests/test_torch_multihost.py), started by
`textreact_tpu_torch.parallel.multihost.spawn` over gloo on the CPU.

Each body builds the model of test_torch_parallel.py from the weights file
the test wrote, runs its cases, and has rank 0 write the results with
torch.save. It imports torch and the port only.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from textreact_tpu_torch.config import ExperimentConfig
from textreact_tpu_torch.models import EncoderDecoder, TransformerConfig
from textreact_tpu_torch.parallel import (full_state_dict, make_mesh,
                                          shard_params)
from textreact_tpu_torch.train import (CheckpointManager, TrainState,
                                       make_optimizer, make_train_step)
from textreact_tpu_torch.train.step import (_dropout_generator,
                                            make_loss_fn)

CFG = dict(task="condition", compute_dtype="float32")


def build(spec: dict, device="cpu") -> EncoderDecoder:
    """The model of `spec` (its two configs and weights file)."""
    enc = TransformerConfig(**spec["enc"])
    dec = TransformerConfig(**spec["dec"])
    module = EncoderDecoder(enc, dec, dtype=torch.float32)
    module.load_state_dict(torch.load(spec["weights"], weights_only=True))
    return module.to(device)


def rows(batch: dict, mesh) -> dict:
    """This rank's dp share of the rows (the tp ranks of a row share it)."""
    n = len(batch["input_ids"]) // mesh.dp_size
    return {k: v[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]
            for k, v in batch.items()}


def trained(spec, batch, dp, tp, zero1=False, steps=1):
    """(mesh, state, per-step metrics) of `steps` steps on a dp x tp mesh,
    or (None, None, None) on a rank outside it."""
    mesh = make_mesh(dp, tp)
    if mesh is None:
        return None, None, None
    module = shard_params(mesh, build(spec))
    cfg = ExperimentConfig(zero1=zero1, **CFG)
    optimizer = make_optimizer(cfg, 100, module.named_parameters(),
                               mesh=mesh, tp_axes=module.tp_axes)
    state = TrainState.create(module, optimizer)
    step = make_train_step(module, cfg, optimizer, dec_pad_id=0,
                           device="cpu")
    metrics = []
    for _ in range(steps):
        state, m = step(state, rows(batch, mesh), seed=1)
        metrics.append({k: float(v) for k, v in m.items()})
    return mesh, state, metrics


def step_cases(rank, world_size, device, out, spec):
    """One step (two with ZeRO-1) on each mesh of the world of four."""
    batch = dict(np.load(spec["batch"]))
    results = {}
    for name, dp, tp, zero1 in (("dp4", 4, 1, False), ("tp2", 1, 2, False),
                                ("dp2tp2", 2, 2, False),
                                ("dp4_replicated", 4, 1, False),
                                ("dp4_zero1", 4, 1, True)):
        steps = 2 if name.startswith("dp4_") else 1
        mesh, state, metrics = trained(spec, batch, dp, tp, zero1, steps)
        if mesh is None:
            continue
        params = full_state_dict(state.module)
        moments = state.optimizer.state_dict()["moments"]
        if rank == 0:
            results[name] = {"metrics": metrics, "params": params,
                             "moments": moments}
    if rank == 0:
        torch.save(results, os.path.join(out, "steps.pt"))


def checkpoint_cases(rank, world_size, device, out, spec, cases):
    """Save on one mesh, restore on another (test_parallel.py:207-281)."""
    batch = dict(np.load(spec["batch"]))
    results = {}
    for save_shape, load_shape, zero1 in cases:
        name = f"{tuple(save_shape)}->{tuple(load_shape)}"
        path = os.path.join(out, name.replace(" ", "").replace(">", ""))
        mesh_a = make_mesh(*save_shape)
        module = shard_params(mesh_a, build(spec))
        cfg = ExperimentConfig(zero1=zero1, **CFG)
        optimizer = make_optimizer(cfg, 100, module.named_parameters(),
                                   mesh=mesh_a, tp_axes=module.tp_axes)
        state = TrainState.create(module, optimizer)
        step = make_train_step(module, cfg, optimizer, 0, device="cpu")
        state, _ = step(state, rows(batch, mesh_a), seed=1)
        mgr = CheckpointManager(path, "val_acc", mesh=mesh_a)
        mgr.save("last", state, {"epoch": 0})
        mgr.finalize()
        saved = {k: v.clone() for k, v in full_state_dict(module).items()}
        state, m_ref = step(state, rows(batch, mesh_a), seed=1)
        after_ref = full_state_dict(module)

        mesh_b = make_mesh(*load_shape)
        if mesh_b is None:
            continue
        module_b = shard_params(mesh_b, build(spec))
        optimizer_b = make_optimizer(cfg, 100, module_b.named_parameters(),
                                     mesh=mesh_b, tp_axes=module_b.tp_axes)
        target = TrainState.create(module_b, optimizer_b)
        restored, meta = CheckpointManager(path, "val_acc", mesh=mesh_b
                                           ).restore("last", target,
                                                     device="cpu")
        got = {k: v.clone() for k, v in full_state_dict(module_b).items()}
        step_b = make_train_step(module_b, cfg, optimizer_b, 0,
                                 device="cpu")
        restored, m_b = step_b(restored, rows(batch, mesh_b), seed=1)
        after_b = full_state_dict(module_b)
        if rank == 0:
            results[name] = {
                "epoch": meta["epoch"], "step": restored.step,
                "bit_equal": all(torch.equal(saved[k], got[k])
                                 for k in saved),
                "loss_ref": float(m_ref["train_loss"]),
                "loss": float(m_b["train_loss"]),
                "param_err": max(float((after_ref[k] - after_b[k]).abs().max())
                                 for k in after_ref)}
    if rank == 0:
        torch.save(results, os.path.join(out, "checkpoints.pt"))


def dropout_rules(rank, world_size, device, out, spec):
    """At p > 0 on dp=2 x tp=2: the ranks' first-step losses on the same
    rows (a tp row draws one set of masks, the dp rows draw two), and after
    three steps whether the replicated parameters are equal to the bit on
    the two tp ranks of each row. Then 3 steps on dp=1 x tp=2."""
    batch = dict(np.load(spec["batch"]))
    mesh = make_mesh(2, 2)
    module = shard_params(mesh, build(spec))
    cfg = ExperimentConfig(**CFG)
    loss_fn = make_loss_fn(module, cfg, 0)
    module.train()
    tensors = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    with torch.no_grad():
        local, _ = loss_fn(tensors, _dropout_generator(
            torch.Generator(), 1, 0, mesh.dp_rank))
    losses = [torch.zeros(()) for _ in range(world_size)]
    dist.all_gather(losses, local.reshape(()))

    def replicas_equal(module):
        equal = True
        for name, p in module.named_parameters():
            if name in module.tp_axes:
                continue
            pieces = [torch.empty_like(p) for _ in range(2)]
            dist.all_gather(pieces, p.detach().contiguous(),
                            group=mesh.tp_group)
            equal &= torch.equal(pieces[0], pieces[1])
        flags = [None] * world_size
        dist.all_gather_object(flags, bool(equal))
        return flags

    _, state, _ = trained(spec, batch, 2, 2, steps=3)
    flags = replicas_equal(state.module)
    # one more update in which tp rank 1's gradient of a replicated table
    # is off in its last bits, as an atomics-summed backward leaves it
    optimizer = state.optimizer
    optimizer.zero_grad()
    loss, _ = make_loss_fn(state.module, cfg, 0)(
        rows(tensors, mesh), _dropout_generator(torch.Generator(), 1, 9,
                                                mesh.dp_rank))
    loss.backward()
    if mesh.tp_rank == 1:
        grad = state.module.encoder.embeddings.position_embeddings.weight.grad
        grad.mul_(1 + 2.0 ** -20)
    optimizer.update()
    perturbed = replicas_equal(state.module)

    _, state, metrics = trained(spec, batch, 1, 2, steps=3)
    if rank == 0:
        torch.save({"losses": [float(x) for x in losses],
                    "tp_equal": flags, "tp_equal_perturbed": perturbed,
                    "tp2_metrics": metrics},
                   os.path.join(out, "dropout.pt"))


def all_cases(rank, world_size, device, out, steps, checkpoints, dropout,
              cases):
    """The three bodies above in one world of four (one start-up)."""
    step_cases(rank, world_size, device, out, steps)
    checkpoint_cases(rank, world_size, device, out, checkpoints, cases)
    dropout_rules(rank, world_size, device, out, dropout)


def trainer_run(rank, world_size, device, argv):
    """One rank of `python -m textreact_tpu_torch ...` under a launcher."""
    from textreact_tpu_torch.cli.main import main
    result = main(list(argv))
    if rank == 0:
        print("RESULT " + json.dumps(result))


def gather_predictions(rank, world_size, device, out):
    """tests/_mp_gather_worker.py's twin: ids 0..4 on rank 0 and 4..8 on
    rank 1 (id 4 repeated, as loader padding repeats it); the union holds
    nine ids and rank 0 alone writes it."""
    from textreact_tpu_torch.parallel import (gather_prediction_dict,
                                              gather_score_dict, is_primary)
    local = {i: {"prediction": [[f"tok{i}a"], [f"tok{i}b"]],
                 "score": [-float(i), -9.0]}
             for i in range(rank * 4, rank * 4 + 5)}
    merged = gather_prediction_dict(local)
    assert sorted(merged) == list(range(9)), sorted(merged)
    assert merged[7]["prediction"] == [["tok7a"], ["tok7b"]], merged[7]
    scores = gather_score_dict({i: float(i) / 10
                                for i in range(rank * 4, rank * 4 + 5)})
    assert sorted(scores) == list(range(9)), sorted(scores)
    if is_primary():
        with open(os.path.join(out, "prediction_test_0.json"), "w") as f:
            json.dump(merged, f)
