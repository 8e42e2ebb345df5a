"""The template-based model's train step on its graphed route, on the card,
at the RetroSyn_tb recipe's full width and depth: SciBERT-base (12 layers
of 768 in 12 heads) over the joint SMILES + text vocabulary, 400 atom and
60 bond template classes, the MLM head, bf16 compute over f32 parameters,
dropout 0.1, micro-batches at L=512 under their (L, L) bond masks, the
benchmark's own traffic (portbench/traffic_template.py).

- Three graphed steps equal three steps of a twin whose `route` is
  "uncaptured", to the bit in the metrics after each step and in every
  parameter and both moments after the three, under torch's deterministic
  algorithms (chip_smoke.deterministic), as two uncaptured runs equal each
  other: the staged (B, L, L) mask, the atom indices, the bond pairs and
  both label arrays reach the graph as the uncaptured step reads them.
- Every encoder layer's self-attention takes the fused kernels under the
  packed bond mask: at every replayed step the packed-mask launch counter
  (ops/fused_attention.py `MASK_3D_LAUNCHES`) adds layers x micro-batches
  forward and backward, and the plain path's count of calls under a 3-D
  mask (models/layers.py `PLAIN_MASK_3D_CALLS`) adds none.

Every test needs a GPU: it carries the `cuda` marker and skips (from a
fixture) without one. On the GPU machine:

    python -m pytest tests/test_torch_template_graphs.py -q -m cuda
"""

import _torch_threads  # noqa: F401  (before torch runs)
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import deterministic as deterministic_algorithms
from portbench import traffic, traffic_template
from textreact_tpu_torch.config import ExperimentConfig
from textreact_tpu_torch.models import TemplateBasedModel, layers
from textreact_tpu_torch.models.config import SCIBERT_BASE
from textreact_tpu_torch.models.factory import init_weights
from textreact_tpu_torch.ops import fused_attention
from textreact_tpu_torch.train import (TrainState, make_accum_train_step,
                                       make_optimizer)

pytestmark = pytest.mark.cuda

CONFIG = json.loads((Path(__file__).resolve().parent.parent / "portbench"
                     / "configs" / "retro_tb.json").read_text())
ROWS, MICRO = 16, 2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    with deterministic_algorithms():
        yield


def _trainer(dev, route: str = "cuda_graphs"):
    """(state, step) of a fresh full-width template model: every call draws
    the same weights."""
    enc = SCIBERT_BASE.replace(
        vocab_size=CONFIG["encoder_ids"]["vocab_size"],
        attention_impl="flash", layernorm_impl="fused")
    model = TemplateBasedModel(enc, CONFIG["num_atom_templates"],
                               CONFIG["num_bond_templates"],
                               dtype=torch.bfloat16, mlm_layer="mlp")
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev)
    cfg = ExperimentConfig(task="retro", template_based=True,
                           unattend_nonbonds=True, template_path="x",
                           mlm=True, mlm_lambda=CONFIG["mlm_lambda"],
                           lr=1e-4, warmup_ratio=0.0)
    opt = make_optimizer(cfg, 100, model.named_parameters())
    step = make_accum_train_step(model, cfg, opt, 0)
    assert step.route == "cuda_graphs"
    step.route = route
    return TrainState.create(model, opt), step


def _micro(seed: int) -> dict:
    mix = dict(traffic.load("train_templates"), micro_batches=MICRO,
               micro_batch_size=ROWS, pool_steps=1)
    return traffic_template.pool(mix, CONFIG, seed)[0]


def _state_tensors(state) -> dict:
    opt = state.optimizer
    out = {n: p.detach() for n, p in state.module.named_parameters()}
    out.update({f"exp_avg {n}": t for n, t in zip(opt.names, opt.exp_avg)})
    out.update({f"exp_avg_sq {n}": t
                for n, t in zip(opt.names, opt.exp_avg_sq)})
    return out


def test_graphed_template_steps_equal_the_uncaptured_route(dev,
                                                           deterministic):
    graphed = _trainer(dev)
    uncaptured = _trainer(dev, route="uncaptured")
    again = _trainer(dev, route="uncaptured")
    micro = _micro(2**31 + 5)
    assert micro["attention_mask"].shape[1:] == (ROWS, 512, 512)
    weights = np.ones(MICRO, np.float32)
    for _ in range(3):
        outs = [step(state, micro, weights, 5)[1]
                for state, step in (graphed, uncaptured, again)]
        for out in outs[1:]:
            assert set(out) == set(outs[0])
            for k in out:
                assert torch.equal(outs[0][k], out[k]), (
                    k, float(outs[0][k]), float(out[k]))
    want = _state_tensors(uncaptured[0])
    for other in (again, graphed):
        got = _state_tensors(other[0])
        diff = {n: float((got[n] - want[n]).abs().max())
                for n in want if not torch.equal(got[n], want[n])}
        assert not diff, diff
    (key,) = graphed[1].graphs.keys.values()
    assert key.micro.replays == 3 * MICRO - 1
    assert graphed[1].graphs.update.replays == 2


def test_replays_count_the_plain_attention_calls(dev):
    state, step = _trainer(dev)
    micro, weights = _micro(2**31 + 6), np.ones(MICRO, np.float32)
    step(state, micro, weights, 5)   # the key's capture
    (key,) = step.graphs.keys.values()
    before, replays = layers.PLAIN_MASK_3D_CALLS, key.micro.replays
    packed = dict(fused_attention.MASK_3D_LAUNCHES)
    n = 3
    for _ in range(n):
        step(state, micro, weights, 5)
    torch.cuda.synchronize()
    assert key.micro.replays - replays == n * MICRO
    calls = n * SCIBERT_BASE.num_hidden_layers * MICRO
    assert fused_attention.MASK_3D_LAUNCHES == {
        "fwd": packed["fwd"] + calls, "bwd": packed["bwd"] + calls}
    assert layers.PLAIN_MASK_3D_CALLS == before
