"""The eval step's routes and results on the CPU.

The route each eval step chooses (`eval_route`): uncaptured on the CPU and
on a mesh, CUDA graphs for a module on one card, remat or not (the eval
forward runs no `remat_block`); the shape key of its graphs, the train
step's key of the same arrays; results that later calls leave as they were;
the eval step against the JAX package's `make_eval_step` on the same
weights (through `from_flax`) and the same numpy batch from a seed, in
float32: the seq2seq branch at 16 decoder positions (the RCR recipe's) and
at 160 (RetroSyn_tf's), and the template branch at top 1 and top 64 edits
with and without the bond mask (RetroSyn_tb); and a template-based trainer
on the CPU, whose validations and test passes write the eval step's route,
keys and seconds into metrics.jsonl. The graphed route itself needs a card:
tests/test_torch_cuda_graphs.py.
"""

import _torch_threads  # noqa: F401  (before torch runs)
import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import textreact_tpu.config as jax_config
import textreact_tpu.train.step as jax_step
from textreact_tpu.models import EncoderDecoder as JaxEncoderDecoder
from test_torch_template import _batch as template_batch
from test_torch_template import _ester_cfg, shared_pair, write_ester_data
from test_torch_train import EXPERIMENT, L, _jax_configs
from textreact_tpu_torch.config import ExperimentConfig
from textreact_tpu_torch.data import Collator
from textreact_tpu_torch.models import (EncoderDecoder, TransformerConfig,
                                        from_flax)
from textreact_tpu_torch.parallel.mesh import make_mesh
from textreact_tpu_torch.parallel.sharding import shard_params
from textreact_tpu_torch.train import make_eval_step
from textreact_tpu_torch.train.graphs import EvalGraphs, TrainGraphs
from textreact_tpu_torch.train.step import (CUDA_GRAPHS, UNCAPTURED,
                                            eval_route, to_device)

# test_torch_train.py's eval tolerances: f32 on both sides, per-example
# means of CE terms of order 1-10 that differ by summation order
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
# a softmax probability of order 1e-3-1 in f32 on both sides
PROB_ATOL = 1e-6
ENC_V, DEC_V = 64, 40


# --- routes and keys --------------------------------------------------------

def _module(remat=False, decoder_positions=32):
    enc, dec = _jax_configs()
    dec = dec.replace(max_position_embeddings=decoder_positions)
    return EncoderDecoder(TransformerConfig(**dataclasses.asdict(enc)),
                          TransformerConfig(**dataclasses.asdict(dec)),
                          dtype=torch.float32, remat=remat)


def _cfg(**kw):
    return ExperimentConfig(**dict(EXPERIMENT, mlm=False, **kw))


def test_route_is_uncaptured_on_the_cpu_and_graphed_on_a_card():
    module = _module()
    assert eval_route(module, torch.device("cpu")) == UNCAPTURED
    assert make_eval_step(module, _cfg(), 0, device="cpu").route == UNCAPTURED
    assert eval_route(module, torch.device("cuda")) == CUDA_GRAPHS
    # remat recomputes in the backward only: the eval forward is graphed
    remat = _module(remat=True)
    assert eval_route(remat, torch.device("cuda")) == CUDA_GRAPHS
    assert make_eval_step(remat, _cfg(), 0, device="cpu").route == UNCAPTURED


def test_route_is_uncaptured_on_a_one_rank_gloo_mesh(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        assert mesh.distributed
        module = shard_params(mesh, _module())
        assert eval_route(module, torch.device("cuda")) == UNCAPTURED
        step = make_eval_step(module, _cfg(), 0, device="cpu")
        assert step.route == UNCAPTURED
    finally:
        dist.destroy_process_group()


def _examples(n, seed, dec_len):
    """Encoder sequences of 40-L tokens and decoder sequences of up to
    `dec_len` tokens (BOS ... EOS)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(40, L + 1))
        body = int(rng.integers(3, dec_len - 1))
        dec = [1] + [int(t) for t in rng.integers(3, DEC_V, body)] + [2]
        out.append({"id": str(i), "index": i,
                    "input_ids": [int(t) for t in rng.integers(5, ENC_V,
                                                               length)],
                    "attention_mask": [1] * length,
                    "decoder_input_ids": dec,
                    "decoder_attention_mask": [1] * len(dec)})
    return out


def _seq2seq_batch(n, seed, rows, dec_len):
    collate = Collator(_cfg(max_dec_length=dec_len), 0, 0)
    return collate(_examples(n, seed, dec_len), fixed_batch=rows,
                   fixed_enc_len=L, fixed_dec_len=dec_len).arrays


def test_the_eval_key_is_the_train_key_of_the_same_arrays():
    """The key of a collated batch names each array's shape and the dtype
    that `to_device` gives it; it is the train step's key of the same
    arrays, alone or as one micro-batch of a stack."""
    arrays = _seq2seq_batch(3, seed=0, rows=4, dec_len=16)
    key = EvalGraphs.key_of(arrays, stacked=False)
    assert key == TrainGraphs.key_of(arrays, stacked=False) \
        == TrainGraphs.key_of({k: v[None] for k, v in arrays.items()},
                              stacked=True)
    on_device = to_device(arrays, torch.device("cpu"))
    assert [name for name, _, _ in key] == sorted(arrays)
    for name, shape, dtype in key:
        assert on_device[name].shape == shape
        assert str(on_device[name].dtype) == f"torch.{dtype}"
    longer = dict(arrays, input_ids=np.zeros((4, L // 2), np.int32))
    assert EvalGraphs.key_of(longer, stacked=False) != key


def test_a_later_call_leaves_a_result_as_it_was():
    module = _module()
    step = make_eval_step(module, _cfg(), 0, device="cpu")
    first = step(_seq2seq_batch(3, seed=1, rows=4, dec_len=16))
    kept = {k: v.clone() for k, v in first.items()}
    second = step(_seq2seq_batch(4, seed=2, rows=4, dec_len=16))
    assert not torch.equal(second["loss"], kept["loss"])
    for k in kept:
        assert torch.equal(first[k], kept[k]), k


# --- the eval step against the JAX package's --------------------------------

def _random_params(module, batch, seed=0):
    shapes = jax.eval_shape(
        lambda b: module.init(jax.random.PRNGKey(0), b["input_ids"],
                              b["attention_mask"], b["decoder_input_ids"]),
        batch)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return jnp.asarray(1.0 + 0.1 * noise if path[-1].key == "scale"
                           else 0.05 * noise)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("dec_len", [16, 160], ids=["rcr", "retro_tf"])
def test_seq2seq_eval_step_matches_jax(dec_len):
    """The RCR recipe's 16 decoder positions and RetroSyn_tf's 160, with a
    row whose targets are all pad (its greedy match passes) and a dummy
    row of the collator."""
    enc, dec = _jax_configs()
    dec = dec.replace(max_position_embeddings=dec_len)
    batch = dict(_seq2seq_batch(3, seed=3, rows=4, dec_len=dec_len))
    batch["decoder_input_ids"] = batch["decoder_input_ids"].copy()
    batch["decoder_input_ids"][1, 1:] = 0
    assert batch["decoder_input_ids"].shape == (4, dec_len)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodule = JaxEncoderDecoder(encoder_config=enc, decoder_config=dec,
                                dtype=jnp.float32)
    params = _random_params(jmodule, jbatch)
    kw = dict(EXPERIMENT, mlm=False, max_dec_length=dec_len)
    jout = jax_step.make_eval_step(
        jmodule, jax_config.ExperimentConfig(**kw), 0)(params, jbatch)
    module = _module(decoder_positions=dec_len)
    module.load_state_dict(from_flax(jax.device_get(params)))
    tout = make_eval_step(module, ExperimentConfig(**kw), 0,
                          device="cpu")(batch)
    assert set(tout) == set(jout) == {"example_mask", "indices", "loss",
                                      "acc"}
    np.testing.assert_allclose(tout["loss"].numpy(), np.asarray(jout["loss"]),
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for key in ("acc", "indices", "example_mask"):
        np.testing.assert_array_equal(tout[key].numpy(),
                                      np.asarray(jout[key]), err_msg=key)
    assert tout["acc"][1] == 1.0 and not module.training


@pytest.mark.parametrize("edit_topk", [1, 64])
@pytest.mark.parametrize("bond_mask", [True, False],
                         ids=["bond_mask", "key_mask"])
def test_template_eval_step_matches_jax(bond_mask, edit_topk):
    """Per-example losses, and the top-k edit values and flat indices of
    the device ranking (`device_topk_edits` on both sides), ties among the
    masked candidates included."""
    pair = shared_pair(bond_mask)
    batch = template_batch(3, seed=6, rows=4, bond_mask=bond_mask)
    jout = jax_step.make_eval_step(pair.jmodule, pair.jcfg, 0,
                                   edit_topk=edit_topk)(
        pair.params, {k: jnp.asarray(v) for k, v in batch.items()})
    tout = make_eval_step(pair.module, pair.cfg, 0, edit_topk=edit_topk,
                          device="cpu")(batch)
    assert set(tout) == set(jout)
    np.testing.assert_allclose(tout["loss"].numpy(), np.asarray(jout["loss"]),
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for key in ("atom_topk_vals", "bond_topk_vals"):
        assert tout[key].shape == jout[key].shape == (4, edit_topk)
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   rtol=0, atol=PROB_ATOL, err_msg=key)
    for key in ("atom_topk_idx", "bond_topk_idx", "indices", "example_mask"):
        np.testing.assert_array_equal(tout[key].numpy(),
                                      np.asarray(jout[key]), err_msg=key)


# --- the trainer ------------------------------------------------------------

def test_the_trainer_records_the_eval_route_keys_and_seconds(tmp_path,
                                                             caplog):
    """A template-based run on the CPU (train with a validation an epoch,
    validate, test): the route is logged beside the train step's, each
    epoch's timing record and the validation's record carry the eval
    step's route, keys and seconds, and the test passes' records its
    route, keys and replays (none: nothing is captured on the CPU)."""
    from textreact_tpu_torch.train.trainer import Trainer
    root = write_ester_data(str(tmp_path / "data"))
    cfg = ExperimentConfig(**_ester_cfg(root, "run", do_valid=True))
    trainer = Trainer(cfg, device="cpu")
    trainer.prepare_data()
    with caplog.at_level(logging.INFO, logger="textreact_tpu_torch"):
        trainer.fit()
        trainer.validate()
        trainer.test()
    assert "train step route: uncaptured; eval step route: uncaptured" \
        in caplog.text
    with open(os.path.join(cfg.save_path, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    timing = [r for r in records if "epoch_seconds" in r]
    validate = [r for r in records if "val_seconds" in r
                and "epoch_seconds" not in r]
    tests = [r for r in records if "test_seconds" in r]
    assert len(timing) == cfg.epochs and len(validate) == 1 \
        and len(tests) == 1
    for r in timing + validate + tests:
        assert (r["eval_route"], r["eval_keys"], r["eval_replays"]) == (
            UNCAPTURED, 0, 0), r
    for r in timing + validate:
        assert r["val_seconds"] > 0.0
