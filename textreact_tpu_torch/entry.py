"""Entry points of the port (twin of __graft_entry__.py).

entry()             -> (fn, example_args): the flagship RCR model's forward
                       (SciBERT-base encoder + bert_l6 decoder), one device;
                       fn(*example_args) gives the logits.
dryrun_multichip(n) -> the multi-device gate, in processes joined by
                       torch.distributed (gloo on the CPU by default), each
                       leg held to the JAX gate's bounds:
                       1. dp x tp training with ZeRO-1, two AdamW steps,
                          the loss falls;
                       2. the corpus-sharded index (one shard per device)
                          equal to the numpy oracle, banned ids included;
                       3. beam generation on tp-sharded parameters equal to
                          the unsharded model's (sequences identical,
                          scores within 1e-5);
                       4. two dp ranks, each collating its own shard, one
                          train step and one eval step and the score
                          gather, against one process with the whole batch
                          (loss and scores within 1e-5);
                       5. dp=2 x tp=2 (four ranks) with uneven dp shards
                          (5 and 4 real rows, mask-padded to 6) and a
                          duplicated id: the same, and exactly 9 unique
                          ids in the gathered scores.

Where the JAX gate runs its legs 4 and 5 as two processes with several
devices each, the port runs one process per device: leg 5 takes four. The
legs that hold several processes against one run at dropout 0, because the
port's masks depend on the dp shape (the JAX package's global-array step
draws the same masks for any shape).

Run: python -c "from textreact_tpu_torch.entry import dryrun_multichip;
dryrun_multichip(4)"
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List

import numpy as np
import torch

from .models.config import BERT_L6_DECODER, SCIBERT_BASE

_GATE_BOUND = 1e-5   # the JAX gate's rtol (__graft_entry__.py:516,788)


def _flagship(tiny: bool = False, dtype=torch.bfloat16, dropout: bool = True,
              seed: int = 0, device="cpu"):
    """The flagship module with weights drawn from `seed` (tiny: the JAX
    gate's cut-down widths, __graft_entry__.py:31-46)."""
    from .models import EncoderDecoder, init_weights
    if tiny:
        enc = SCIBERT_BASE.replace(vocab_size=512, hidden_size=256,
                                   num_hidden_layers=2, num_attention_heads=8,
                                   intermediate_size=512,
                                   max_position_embeddings=128)
        dec = BERT_L6_DECODER.replace(vocab_size=320, hidden_size=256,
                                      num_hidden_layers=2,
                                      num_attention_heads=8,
                                      intermediate_size=512,
                                      max_position_embeddings=64)
    else:
        enc, dec = SCIBERT_BASE, BERT_L6_DECODER.replace(vocab_size=315)
    if not dropout:
        enc = enc.replace(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
        dec = dec.replace(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    module = EncoderDecoder(enc, dec, dtype=dtype)
    init_weights(module, torch.Generator().manual_seed(seed))
    return module.to(device)


def _example_batch(B, L, Ld, enc_vocab, dec_vocab, seed=0
                   ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "input_ids": rng.integers(1, enc_vocab, (B, L)).astype(np.int64),
        "attention_mask": np.ones((B, L), np.int64),
        "decoder_input_ids": rng.integers(1, dec_vocab, (B, Ld)).astype(
            np.int64),
        "decoder_attention_mask": np.ones((B, Ld), np.int64),
    }


def entry(device=None, tiny: bool = False):
    """(fn, example_args): fn(module, input_ids, attention_mask,
    decoder_input_ids, decoder_attention_mask) -> logits, on the CUDA card
    unless `device` names another."""
    from .models.factory import resolve_device
    device = resolve_device(device)
    module = _flagship(tiny=tiny, device=device).eval()
    B, L, Ld = 8, (64 if tiny else 512), 16
    batch = _example_batch(B, L, Ld, module.encoder_config.vocab_size,
                           module.decoder_config.vocab_size)
    args = [torch.as_tensor(batch[k], device=device)
            for k in ("input_ids", "attention_mask", "decoder_input_ids",
                      "decoder_attention_mask")]

    @torch.no_grad()
    def fn(module, input_ids, attention_mask, decoder_input_ids,
           decoder_attention_mask):
        return module(input_ids=input_ids, attention_mask=attention_mask,
                      decoder_input_ids=decoder_input_ids,
                      decoder_attention_mask=decoder_attention_mask)["logits"]

    return fn, (module, *args)


def _gate_cfg(dtype: str, **kw):
    from .config import ExperimentConfig
    return ExperimentConfig(task="condition", compute_dtype=dtype, lr=1e-3,
                            scheduler="constant", warmup_ratio=0.0, **kw)


def _tp_for(n: int) -> int:
    return 2 if n % 2 == 0 and n >= 4 else 1


def _write(out: str, name: str, obj) -> None:
    with open(os.path.join(out, name), "w") as f:
        json.dump(obj, f)


def _read(out: str, name: str):
    with open(os.path.join(out, name)) as f:
        return json.load(f)


# --- leg 1 -------------------------------------------------------------------

def _train_worker(rank: int, world_size: int, device: str, out: str) -> None:
    from .parallel import make_mesh, shard_params
    from .train import TrainState, make_optimizer, make_train_step
    tp = _tp_for(world_size)
    mesh = make_mesh(world_size // tp, tp)
    module = _flagship(tiny=True, device=device)
    shard_params(mesh, module)
    cfg = _gate_cfg("bfloat16", zero1=True)
    B, L, Ld = 2 * mesh.dp_size, 64, 16
    batch = _example_batch(B, L, Ld, module.encoder_config.vocab_size,
                           module.decoder_config.vocab_size)
    rows = slice(2 * mesh.dp_rank, 2 * mesh.dp_rank + 2)
    local = {k: v[rows] for k, v in batch.items()}
    optimizer = make_optimizer(cfg, 100, module.named_parameters(),
                               mesh=mesh, tp_axes=module.tp_axes)
    state = TrainState.create(module, optimizer)
    step = make_train_step(module, cfg, optimizer, dec_pad_id=0,
                           device=device)
    losses = []
    for _ in range(2):
        state, metrics = step(state, local, seed=1)
        losses.append(float(metrics["train_loss"]))
    if rank == 0:
        _write(out, "train.json", {"losses": losses, "dp": mesh.dp_size,
                                   "tp": mesh.tp_size})


def _dryrun_train(n: int, device: str, out: str) -> None:
    from .parallel.multihost import spawn
    spawn("textreact_tpu_torch.entry:_train_worker", n, {"out": out},
          devices=[device] * n)
    res = _read(out, "train.json")
    losses = res["losses"]
    assert all(np.isfinite(x) for x in losses), losses
    assert losses[1] < losses[0], losses
    print(f"dryrun_multichip({n}): train mesh dp={res['dp']} tp={res['tp']} "
          f"zero1 loss {losses[0]:.4f} -> {losses[1]:.4f} ok", flush=True)


# --- leg 2 -------------------------------------------------------------------

def _dryrun_retrieval(n: int, device: str) -> None:
    from .ops.topk import numpy_reference_topk
    from .retrieval.engine import FlatIndex
    rng = np.random.default_rng(3)
    corpus = (rng.random((1024, 128)) < 0.1).astype(np.int8)
    queries = corpus[:16]      # self-queries: tie order and banning
    banned = np.arange(16, dtype=np.int32)[:, None]   # ban the gold row
    index = FlatIndex(corpus, devices=[device] * n)
    vals, idx = index.search(queries, k=10, banned=banned)
    ref_vals, ref_idx = numpy_reference_topk(queries, corpus, 10, banned)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(vals, ref_vals)
    print(f"dryrun_multichip({n}): sharded retrieval parity "
          f"(N={corpus.shape[0]}, shards={n}, masked top-10) ok", flush=True)


# --- leg 3 -------------------------------------------------------------------

def _generate_inputs(module):
    batch = _example_batch(2, 64, 8, module.encoder_config.vocab_size,
                           module.decoder_config.vocab_size, seed=5)
    return {"input_ids": batch["input_ids"],
            "attention_mask": batch["attention_mask"]}


def _generate(module):
    from .inference.predictor import Generator
    return Generator(module, num_beams=3, max_length=8).generate(
        _generate_inputs(module))


def _generate_worker(rank: int, world_size: int, device: str,
                     out: str) -> None:
    from .parallel import make_mesh, shard_params
    tp = _tp_for(world_size)
    mesh = make_mesh(world_size // tp, tp)
    module = _flagship(tiny=True, dtype=torch.float32, seed=2, device=device)
    shard_params(mesh, module)
    seqs, scores = _generate(module)
    if rank == 0:
        _write(out, "generate.json", {"seqs": seqs.tolist(),
                                      "scores": scores.tolist(),
                                      "tp": mesh.tp_size})


def _dryrun_generate(n: int, device: str, out: str) -> None:
    from .parallel.multihost import spawn
    ref_seqs, ref_scores = _generate(
        _flagship(tiny=True, dtype=torch.float32, seed=2, device=device))
    spawn("textreact_tpu_torch.entry:_generate_worker", n, {"out": out},
          devices=[device] * n)
    got = _read(out, "generate.json")
    np.testing.assert_array_equal(np.asarray(got["seqs"]), ref_seqs)
    np.testing.assert_allclose(np.asarray(got["scores"]), ref_scores,
                               rtol=_GATE_BOUND, atol=_GATE_BOUND)
    print(f"dryrun_multichip({n}): tp-sharded beam generation parity "
          f"(tp={got['tp']}) ok", flush=True)


# --- legs 4 and 5 --------------------------------------------------------------

def _examples(n: int, seed: int, enc_vocab: int, dec_vocab: int) -> List[Dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        m, md = int(rng.integers(5, 20)), int(rng.integers(2, 7))
        out.append({
            "id": f"ex{i}", "index": i,
            "input_ids": rng.integers(1, enc_vocab, m).tolist(),
            "attention_mask": [1] * m,
            "decoder_input_ids": rng.integers(1, dec_vocab, md).tolist(),
            "decoder_attention_mask": [1] * md,
        })
    return out


def _data_path_shards(leg: str):
    """The dp shards of a leg's examples, each collated to one static shape:
    leg 4, 8 examples in two even shards; leg 5, 9 examples in shards of 5
    and 4 + a duplicate of example 0, each mask-padded to 6 rows."""
    from .data.collate import Collator
    cfg = _gate_cfg("float32", max_length=32, max_dec_length=8)
    collator = Collator(cfg, enc_pad_id=0, dec_pad_id=0, static_shapes=True)
    if leg == "even":
        ex = _examples(8, 17, 512, 320)
        return [collator(ex[:4], fixed_batch=4), collator(ex[4:],
                                                          fixed_batch=4)]
    ex = _examples(9, 23, 512, 320)
    return [collator(ex[:5], fixed_batch=6),
            collator(ex[5:] + [dict(ex[0])], fixed_batch=6)]


def _train_and_score(module, batch: Dict[str, np.ndarray], device) -> tuple:
    """One train step and one eval step on `batch`; (train loss, {index:
    per-example eval loss} of the real rows, the two steps' routes)."""
    from .train import (TrainState, make_eval_step, make_optimizer,
                        make_train_step)
    cfg = _gate_cfg("float32", max_length=32, max_dec_length=8)
    mesh = getattr(module, "mesh", None)
    optimizer = make_optimizer(cfg, 10, module.named_parameters(), mesh=mesh,
                               tp_axes=getattr(module, "tp_axes", None))
    state = TrainState.create(module, optimizer)
    step = make_train_step(module, cfg, optimizer, dec_pad_id=0,
                           device=device)
    state, metrics = step(state, batch, seed=1)
    eval_step = make_eval_step(module, cfg, dec_pad_id=0, device=device)
    res = eval_step(batch)
    mask = res["example_mask"].cpu().numpy().astype(bool)
    scores = {int(i): float(v) for i, v, m in zip(
        res["indices"].cpu().numpy(), res["loss"].double().cpu().numpy(),
        mask) if m}
    return (float(metrics["train_loss"]), scores,
            {"train": step.route, "eval": eval_step.route})


def _data_path_worker(rank: int, world_size: int, device: str, out: str,
                      leg: str) -> None:
    from .parallel import gather_score_dict, is_primary, make_mesh
    from .parallel import shard_params
    tp = 2 if leg == "uneven" else 1
    mesh = make_mesh(world_size // tp, tp)
    module = _flagship(tiny=True, dtype=torch.float32, dropout=False,
                       device=device)
    shard_params(mesh, module)
    batch = _data_path_shards(leg)[mesh.dp_rank]   # by dp rank, not rank
    loss, scores, routes = _train_and_score(module, batch.arrays, device)
    scores = gather_score_dict(scores)
    if is_primary():
        _write(out, f"{leg}.json", {"train_loss": loss, "scores": {
            str(k): scores[k] for k in sorted(scores)}, "world": world_size,
            "routes": routes})


def _dryrun_data_path(leg: str, world: int, device: str, out: str) -> None:
    from .parallel.multihost import spawn
    shards = _data_path_shards(leg)
    whole = {k: np.concatenate([s.arrays[k] for s in shards])
             for k in shards[0].arrays}
    ref_loss, ref_scores, ref_routes = _train_and_score(
        _flagship(tiny=True, dtype=torch.float32, dropout=False,
                  device=device), whole, device)
    spawn("textreact_tpu_torch.entry:_data_path_worker", world,
          {"out": out, "leg": leg}, devices=[device] * world)
    got = _read(out, f"{leg}.json")
    n_ids = 8 if leg == "even" else 9
    assert sorted(got["scores"]) == sorted(str(k) for k in ref_scores) \
        == sorted(str(i) for i in range(n_ids)), (got, ref_scores)
    np.testing.assert_allclose(got["train_loss"], ref_loss, rtol=_GATE_BOUND)
    for k, v in ref_scores.items():
        np.testing.assert_allclose(got["scores"][str(k)], v,
                                   rtol=_GATE_BOUND, err_msg=str(k))
    routes = (f"(train/eval step routes: one process {ref_routes['train']}/"
              f"{ref_routes['eval']}, the ranks {got['routes']['train']}/"
              f"{got['routes']['eval']})")
    if leg == "even":
        print("dryrun_multichip: 2-process data path (static collation + "
              f"per-rank shards + score gather) matches one process {routes} "
              "ok", flush=True)
    else:
        print("dryrun_multichip: 4-process dp=2 x tp=2 leg (uneven shards, "
              f"duplicate-id drop, 9 unique ids) matches one process {routes} "
              "ok", flush=True)


def dryrun_multichip(n_devices: int = 4, device=None) -> None:
    """The five legs on `device` (None: the CUDA card, raising without one;
    each process of a leg takes it, so the processes share it): gloo joins
    the processes. On the card the kernels are built before any process
    starts. Raises on the first leg that fails; prints one ok line per
    leg."""
    from .models.factory import resolve_device
    device = str(resolve_device(device))
    if device.startswith("cuda"):
        from .ops import _build, fused_attention
        _build.build_all([*fused_attention.LIBRARIES, "fused_layernorm",
                          "exact_topk", "decode_attention"])
    with tempfile.TemporaryDirectory(prefix="tr_dryrun_") as out:
        _dryrun_train(n_devices, device, out)
        _dryrun_retrieval(n_devices, device)
        _dryrun_generate(n_devices, device, out)
        _dryrun_data_path("even", 2, device, out)
        _dryrun_data_path("uneven", 4, device, out)
