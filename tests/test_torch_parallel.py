"""The port's multi-device slice on the CPU, over gloo: the sharding rules
against the JAX package's, dp x tp steps against one device and against the
JAX step, ZeRO-1 against replicated moments, the elastic checkpoint, the
dropout rules of a mesh, the loader's dp shards and the corpus-sharded
index.

The multi-process cases start their ranks with
`textreact_tpu_torch.parallel.multihost.spawn` (a `file://` store in a
temporary directory, never a port); their bodies are in
tests/_torch_parallel_worker.py. Each spawn runs several cases, so the
fixtures are module-scoped.

Bounds: f32 everywhere. Against one device of the port 1e-5 (the meshes
reorder sums only: tp adds two partial products, dp four gradients);
against the JAX step the bounds of tests/test_parallel.py:59-66 (loss rtol
1e-4, grad_norm rtol 1e-3).
"""

import _torch_threads  # noqa: F401  (before torch runs)
import dataclasses
import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_worker import build
from textreact_tpu.config import ExperimentConfig as JaxExperimentConfig
from textreact_tpu.models import BERT_L6_DECODER as JAX_DEC
from textreact_tpu.models import SCIBERT_BASE as JAX_ENC
from textreact_tpu.models import EncoderDecoder as JaxEncoderDecoder
from textreact_tpu.parallel.sharding import param_spec as jax_param_spec
from textreact_tpu.train import optim as jax_optim
from textreact_tpu.train import step as jax_step
from textreact_tpu_torch.config import ExperimentConfig
from textreact_tpu_torch.models import TransformerConfig, from_flax
from textreact_tpu_torch.ops.topk import numpy_reference_topk
from textreact_tpu_torch.parallel import param_spec
from textreact_tpu_torch.parallel.mesh import Mesh
from textreact_tpu_torch.parallel.multihost import spawn
from textreact_tpu_torch.retrieval.engine import FlatIndex
from textreact_tpu_torch.train import (TrainState, make_optimizer,
                                       make_train_step)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = "_torch_parallel_worker"
PORT_TOL = 1e-5
JAX_LOSS_RTOL, JAX_GN_RTOL = 1e-4, 1e-3

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
# tests/test_parallel.py's geometry, at dropout 0
ENC = JAX_ENC.replace(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=128,
                      max_position_embeddings=64, type_vocab_size=1,
                      **NO_DROPOUT)
DEC = JAX_DEC.replace(vocab_size=64, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=128,
                      max_position_embeddings=32, **NO_DROPOUT)

CASES = [((4, 1), (2, 1), False), ((2, 2), (2, 1), True),
         ((2, 2), (4, 1), True)]

# the kernels' paths (their plain versions here), at dropout 0.1
DROP_ENC = ENC.replace(hidden_size=128, num_attention_heads=4,
                       intermediate_size=256, max_position_embeddings=128,
                       attention_impl="flash", layernorm_impl="fused",
                       hidden_dropout_prob=0.1,
                       attention_probs_dropout_prob=0.1)
DROP_DEC = DEC.replace(hidden_size=128, num_attention_heads=4,
                       intermediate_size=256, attention_impl="flash",
                       layernorm_impl="fused", hidden_dropout_prob=0.1,
                       attention_probs_dropout_prob=0.1)


def make_batch(B=8, L=32, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "input_ids": rng.integers(1, 128, (B, L)).astype(np.int64),
        "attention_mask": np.ones((B, L), np.int64),
        "decoder_input_ids": rng.integers(1, 64, (B, 8)).astype(np.int64),
        "decoder_attention_mask": np.ones((B, 8), np.int64),
        "example_mask": np.ones((B,), np.int64),
        "indices": np.arange(B, dtype=np.int64),
    }


def jax_params(module, batch):
    return module.init(jax.random.PRNGKey(0),
                       **{k: jnp.asarray(batch[k], jnp.int32)
                          for k in ("input_ids", "attention_mask",
                                    "decoder_input_ids",
                                    "decoder_attention_mask")})


def write_spec(tmp, enc, dec, params, batch):
    """The model and batch for the ranks: configs, weights file, batch
    file."""
    spec = {"enc": dataclasses.asdict(enc), "dec": dataclasses.asdict(dec),
            "weights": os.path.join(tmp, "weights.pt"),
            "batch": os.path.join(tmp, "batch.npz")}
    os.makedirs(tmp, exist_ok=True)
    torch.save(from_flax(jax.device_get(params)), spec["weights"])
    np.savez(spec["batch"], **batch)
    return spec


def one_device(spec, batch, steps=1):
    """(metrics of each step, parameters after them) on one process."""
    module = build(spec)
    cfg = ExperimentConfig(task="condition", compute_dtype="float32")
    optimizer = make_optimizer(cfg, 100, module.named_parameters())
    state = TrainState.create(module, optimizer)
    step = make_train_step(module, cfg, optimizer, 0, device="cpu")
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch, seed=1)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, module.state_dict()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every multi-process case in one world of four ranks (tests/
    _torch_parallel_worker.py:all_cases), beside JAX's step and one device
    of the port."""
    tmp = str(tmp_path_factory.mktemp("par_world"))
    batch = make_batch()
    jmodule = JaxEncoderDecoder(encoder_config=ENC, decoder_config=DEC,
                                dtype=jnp.float32)
    params = jax_params(jmodule, batch)
    spec = write_spec(os.path.join(tmp, "steps"), ENC, DEC, params, batch)
    jcfg = JaxExperimentConfig(task="condition", compute_dtype="float32")
    tx = jax_optim.make_optimizer(jcfg, 100)
    jstate = jax_step.TrainState.create(params, tx)
    jstep = jax_step.make_train_step(jmodule, jcfg, tx, dec_pad_id=0)
    _, jm = jstep(jstate, {k: jnp.asarray(v, jnp.int32)   # donates params
                           for k, v in batch.items()}, jax.random.PRNGKey(1))
    single, single_params = one_device(spec, batch)

    drop_batch = make_batch(B=4, L=128)
    drop_module = JaxEncoderDecoder(encoder_config=DROP_ENC,
                                    decoder_config=DROP_DEC,
                                    dtype=jnp.float32)
    drop_spec = write_spec(os.path.join(tmp, "dropout"), DROP_ENC, DROP_DEC,
                           jax_params(drop_module, drop_batch), drop_batch)
    drop_single, _ = one_device(drop_spec, drop_batch, steps=3)

    spawn(f"{WORKER}:all_cases", 4,
          {"out": tmp, "steps": spec, "checkpoints": spec,
           "dropout": drop_spec, "cases": CASES}, pythonpath=[HERE])
    load = lambda name: torch.load(os.path.join(tmp, name),   # noqa: E731
                                   weights_only=True)
    dropout = load("dropout.pt")
    dropout["single"] = drop_single
    return {"steps": {"jax": {k: float(v) for k, v in jm.items()},
                      "single": single[0], "single_params": single_params,
                      "mesh": load("steps.pt")},
            "checkpoints": load("checkpoints.pt"), "dropout": dropout}


@pytest.fixture(scope="module")
def steps(world):
    return world["steps"]


@pytest.fixture(scope="module")
def checkpoints(world):
    return world["checkpoints"]


@pytest.fixture(scope="module")
def dropout(world):
    return world["dropout"]


# --- param_spec --------------------------------------------------------------

def _flax_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flax_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("mlm_layer", [None, "mlp", "linear"])
def test_param_spec_matches_jax_on_every_converted_name(mlm_layer):
    """Every flax leaf's PartitionSpec, carried to the port's name: a
    kernel's P(None, 'tp') is the weight's axis 0, P('tp', None) axis 1, a
    bias's P('tp') axis 0, P() none (tests/test_parallel.py:99-118)."""
    from jax.tree_util import DictKey
    from jax.sharding import PartitionSpec as P
    module = JaxEncoderDecoder(encoder_config=ENC, decoder_config=DEC,
                               dtype=jnp.float32, mlm_layer=mlm_layer)
    batch = make_batch(B=2)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), **{
            k: jnp.asarray(batch[k], jnp.int32) for k in (
                "input_ids", "attention_mask", "decoder_input_ids",
                "decoder_attention_mask")}, mlm_prefix_len=4))["params"]
    port = build_port(mlm_layer)
    names = dict(port.named_parameters())
    converted = from_flax({"params": jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes)})
    assert set(converted) == set(names)
    want_axis = {P(None, "tp"): 0, P("tp", None): 1, P("tp"): 0, P(): None}
    n_split = 0
    for (path, leaf), name in zip(_flax_paths(shapes), converted):
        spec = jax_param_spec(tuple(DictKey(p) for p in path), leaf)
        got = param_spec(name, names[name])
        assert got == want_axis[spec], (path, name, spec, got)
        n_split += got is not None
    # an encoder layer splits q, k, v, intermediate (weight and bias) and
    # two output weights; a decoder layer also its cross-attention's seven
    assert n_split == 2 * 10 + 2 * 17


def build_port(mlm_layer):
    from textreact_tpu_torch.models import EncoderDecoder
    return EncoderDecoder(TransformerConfig(**dataclasses.asdict(ENC)),
                          TransformerConfig(**dataclasses.asdict(DEC)),
                          dtype=torch.float32, mlm_layer=mlm_layer)


# --- dp x tp steps -----------------------------------------------------------

@pytest.mark.parametrize("mesh", ["dp4", "tp2", "dp2tp2"])
def test_mesh_step_matches_one_device_and_jax(steps, mesh):
    got = steps["mesh"][mesh]
    m = got["metrics"][0]
    for key in ("train_loss", "grad_norm"):
        np.testing.assert_allclose(m[key], steps["single"][key],
                                   rtol=PORT_TOL, err_msg=key)
    np.testing.assert_allclose(m["train_loss"], steps["jax"]["train_loss"],
                               rtol=JAX_LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"], steps["jax"]["grad_norm"],
                               rtol=JAX_GN_RTOL)
    for name, p in steps["single_params"].items():
        np.testing.assert_allclose(got["params"][name].numpy(), p.numpy(),
                                   rtol=0, atol=PORT_TOL, err_msg=name)


@pytest.mark.parametrize("what", ["metrics", "params", "moments"])
def test_zero1_equals_replicated_moments(steps, what):
    """Two steps at dp=4: ZeRO-1's sliced moments give what replicated
    moments give, to the bit (tests/test_parallel.py:121-154 holds them to
    the loss bounds)."""
    a = steps["mesh"]["dp4_zero1"][what]
    b = steps["mesh"]["dp4_replicated"][what]
    if what == "metrics":
        assert a == b
        return
    assert set(a) == set(b) and a
    for name in a:
        if what == "params":
            assert torch.equal(a[name], b[name]), name
        else:
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(a[name][k], b[name][k]), (name, k)


# --- elastic checkpoints -----------------------------------------------------

@pytest.mark.parametrize("save_shape,load_shape,zero1", CASES)
def test_checkpoint_restores_on_another_mesh(checkpoints, save_shape,
                                             load_shape, zero1):
    """A checkpoint written on one (dp, tp) shape restores on another
    (tests/test_parallel.py:207-281): parameters equal to the bit, the next
    step's loss that of the uninterrupted run, and its update too."""
    got = checkpoints[f"{tuple(save_shape)}->{tuple(load_shape)}"]
    assert got["epoch"] == 0 and got["step"] == 2
    assert got["bit_equal"]
    np.testing.assert_allclose(got["loss"], got["loss_ref"], rtol=PORT_TOL)
    assert got["param_err"] <= PORT_TOL


# --- dropout on a mesh --------------------------------------------------------

def test_tp_replicas_keep_equal_replicated_parameters(dropout):
    """p = 0.1, three steps: the parameters that tp does not split are
    equal to the bit on the two tp ranks of each row (one residual-dropout
    seed per tp group); and after one more update in which one tp rank's
    gradient of a replicated table was off in its last bits (as a backward
    that sums by atomics leaves it on the card), because the optimizer
    averages those gradients over the tp group."""
    assert dropout["tp_equal"] == [True] * 4
    assert dropout["tp_equal_perturbed"] == [True] * 4


def test_dp_ranks_draw_different_masks(dropout):
    """The same rows on all four ranks of dp=2 x tp=2: the two ranks of a
    tp row draw one set of masks, the two dp rows two different sets."""
    l0, l1, l2, l3 = dropout["losses"]
    assert l0 == l1 and l2 == l3
    assert l0 != l2


def test_tp_heads_draw_the_masks_of_the_unsharded_layer(dropout):
    """dp=1 x tp=2 at p = 0.1 for three steps equals one device: each rank
    draws its heads' attention masks out of the whole layer's (the head
    offset) and the residual masks of the whole rows."""
    for got, want in zip(dropout["tp2_metrics"], dropout["single"]):
        for key in ("train_loss", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=PORT_TOL,
                                       err_msg=key)


# --- the loader's dp shards ------------------------------------------------------

def test_trainer_loaders_shard_by_dp_rank():
    """A rank loads the rows of its dp index, never of its global rank: the
    two tp ranks of a row get the same rows, the dp rows split the data."""
    from textreact_tpu_torch.train.trainer import Trainer
    cfg = ExperimentConfig(task="condition", batch_size=4)
    trainer = Trainer.__new__(Trainer)   # the loaders alone
    trainer.cfg = cfg
    trainer.test_dataset = None
    trainer.collator = None
    order = {}
    for rank in range(4):
        dp_rank, tp_rank = divmod(rank, 2)
        trainer.mesh = Mesh(dp_size=2, tp_size=2, dp_rank=dp_rank,
                            tp_rank=tp_rank)
        trainer.dp_size = 2
        loader = trainer._loaders(list(range(10)), eval_mode=False)[0]
        assert loader.batch_size == 2   # half of the global batch of 4
        order[rank] = loader._order()
    assert order[0] == order[1] and order[2] == order[3]
    assert sorted(order[0] + order[2]) == list(range(10))


# --- the corpus-sharded index ----------------------------------------------------

@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("banned", [False, True])
def test_sharded_index_equals_the_oracle(shards, banned, chunked,
                                         monkeypatch):
    """`FlatIndex(devices=["cpu"] * S)`: self-queries (ties, the gold row
    banned) equal the numpy oracle to the bit, and the unsharded index;
    chunked: 301 queries in chunks of 128, each chunk queued on every
    shard before any is read."""
    rng = np.random.default_rng(3)
    corpus = (rng.random((301, 128)) < 0.1).astype(np.int8)
    rows = (np.arange(301) if chunked
            else np.concatenate([np.arange(16), np.arange(150, 158)]))
    queries = corpus[rows]
    ban = rows.astype(np.int32)[:, None] if banned else None
    if chunked:
        from textreact_tpu_torch.retrieval import engine
        monkeypatch.setattr(engine, "SEARCH_BUDGET_BYTES", 128 * 200)
    index = FlatIndex(corpus, devices=["cpu"] * shards)
    vals, idx = index.search(queries, k=10, banned=ban)
    ref_vals, ref_idx = numpy_reference_topk(queries, corpus, 10, ban)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(vals, ref_vals)
    one_vals, one_idx = FlatIndex(corpus, device="cpu").search(
        queries, k=10, banned=ban)
    np.testing.assert_array_equal(idx, one_idx)
    np.testing.assert_array_equal(vals, one_vals)
    ref = index.reference_search(queries, k=10, banned=ban)
    np.testing.assert_array_equal(ref[1], ref_idx)
