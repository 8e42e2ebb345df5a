"""The Generator's CUDA graphs against the uncaptured device-state loop, on
the card.

Two-layer encoder and decoder at the RCR recipe's widths (SciBERT-base and
bert_l6: hidden 768 in 12 heads, bf16 weights, 32 requests of 512 tokens),
decoding at beam 15 over 16 positions (one window) and at the retro
geometry, beam 20 over 160 positions (the windows 48, 80, 160). Each
compares the graphed route with the same weights' uncaptured loop
(`Generator.route = "uncaptured"`) to the bit: on two batches through the
same graphs, on batches that stop early under an lm-head bias that
favours EOS, and on a new key after them.

The train step's graphs (train/graphs.py) the same way: the two layers at
full width with the MLM head, bf16 compute over f32 parameters, dropout
0.1, micro-batches of 8 rows at L=512; each graphed train step against
a twin on the same weights whose `route` is "uncaptured", to the bit in
loss, gradient norm, every parameter and both moments, under torch's
deterministic algorithms (chip_smoke.deterministic: without them torch's
embedding backward sums a table's repeated rows by atomics, and two
uncaptured runs differ there); the dropout seed taken up at every replay; a weight-0 pad; two keys alternating; no host
wait in a replayed step; the counters against a trace.

The eval step's graphs (train/graphs.py `EvalGraphs`) the same way, at 32
rows of L=512: the RCR model's forward (top 1) and a template model's at
the RetroSyn_tb recipe's 400 atom and 60 bond classes under the bond mask
(top 500 edits), each against the uncaptured route to the bit, on two
batches of one key and with the first result left as it was by the
second; keys alternating and a new one captured; no host wait in a replay;
the counters against a trace; and a validation between two train keys,
after which the new key's capture equals a run that saw no validation.

Every test needs a GPU: it carries the `cuda` marker and skips (from a
fixture) without one. On the GPU machine:

    python -m pytest tests/test_torch_cuda_graphs.py -q -m cuda
"""

import _torch_threads  # noqa: F401  (before torch runs)
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import deterministic as deterministic_algorithms
from chip_smoke import device_events
from textreact_tpu_torch.bench_train import experiment, make_batch
from textreact_tpu_torch.inference import Generator
from textreact_tpu_torch.inference.beam import STOP_LAG
from textreact_tpu_torch.config import ExperimentConfig
from textreact_tpu_torch.data.collate import IGNORE_INDEX
from textreact_tpu_torch.models import EncoderDecoder, TemplateBasedModel
from textreact_tpu_torch.models.config import BERT_L6_DECODER, SCIBERT_BASE
from textreact_tpu_torch.models.factory import init_weights
from textreact_tpu_torch.ops import (decode_attention, fused_attention,
                                     fused_layernorm)
from textreact_tpu_torch.train import (TrainState, make_accum_train_step,
                                       make_eval_step, make_optimizer,
                                       make_train_step)

pytestmark = pytest.mark.cuda

LAYERS = 2
B, L = 32, 512
# geometry -> (beams, decoder positions)
GEOMETRIES = {"rcr": (15, 16), "retro": (20, 160)}
# added to the lm head's EOS logit: random weights then end every beam
# within a few steps
EOS_BIAS = 6.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(dev, eos_bias: float = 0.0, seed: int = 0) -> EncoderDecoder:
    kernels = dict(attention_impl="flash", layernorm_impl="fused")
    enc = SCIBERT_BASE.replace(num_hidden_layers=LAYERS, **kernels)
    dec = BERT_L6_DECODER.replace(num_hidden_layers=LAYERS, **kernels)
    model = EncoderDecoder(enc, dec, dtype=torch.bfloat16,
                           param_dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.decoder.lm_head.bias[dec.eos_token_id] += eos_bias
    return model.to(dev).eval()


def _batch(seed: int, rows: int = B) -> dict:
    rng = np.random.default_rng(seed)
    lengths = rng.integers(16, L + 1, rows)
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(100, SCIBERT_BASE.vocab_size, (rows, L)) * mask
    return {"input_ids": ids.astype(np.int32), "attention_mask": mask}


def _pair(model, geometry: str):
    """(the graphed Generator, the uncaptured one) on the same weights."""
    beams, T = GEOMETRIES[geometry]
    graphed = Generator(model, num_beams=beams, max_length=T)
    uncaptured = Generator(model, num_beams=beams, max_length=T)
    uncaptured.route = "uncaptured"
    assert graphed.route == "cuda_graphs"
    return graphed, uncaptured


def _same(got, want) -> None:
    """Beams and scores equal to the bit."""
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].dtype == want[1].dtype == np.float32
    np.testing.assert_array_equal(got[1].view(np.uint32),
                                  want[1].view(np.uint32))


def _cache_pointers(gen) -> list:
    cache = gen._graphed.cache
    return [t.data_ptr() for t in (cache.self_k + cache.self_v + cache.cross_k
                                   + cache.cross_v + [cache.cross_bias])]


def _counts() -> tuple:
    return fused_attention.LAUNCHES, fused_layernorm.LAUNCHES


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_two_batches_through_the_same_graphs(dev, geometry):
    """The first batch captures, the second replays: each equals the
    uncaptured loop on its own batch, the two batches' beams differ (so a
    graph reading the first batch's inputs would fail), the cache's tensors
    keep their storage, and the counters count the kernels the card ran:
    the encoder's attention a layer, two LNs an encoder layer and three a
    decoder layer each replay, and the decode self-attention's kernel a
    decoder layer each step, replayed or uncaptured."""
    model = _model(dev)
    graphed, uncaptured = _pair(model, geometry)
    batches = [_batch(1), _batch(2)]
    results = []
    for n, batch in enumerate(batches):
        before = _counts()
        decode_before = decode_attention.DECODE_LAUNCHES
        got = graphed.generate(batch)
        after = _counts()
        assert (graphed.last_capture_ms > 0) == (n == 0)
        assert after[0] - before[0] == LAYERS
        assert after[1] - before[1] == (2 * LAYERS
                                        + 3 * LAYERS * graphed.last_replays)
        assert (decode_attention.DECODE_LAUNCHES - decode_before
                == LAYERS * graphed.last_replays)
        if n == 0:
            pointers = _cache_pointers(graphed)
        assert _cache_pointers(graphed) == pointers
        decode_before = decode_attention.DECODE_LAUNCHES
        _same(got, uncaptured.generate(batch))
        assert (decode_attention.DECODE_LAUNCHES - decode_before
                == LAYERS * uncaptured.last_replays)
        assert graphed.last_steps == uncaptured.last_steps
        results.append(got)
    assert not np.array_equal(results[0][0], results[1][0])


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_batches_that_stop_early(dev, geometry):
    """Under an lm-head bias that favours EOS the search stops long before
    the cache is full: the graphs equal the uncaptured loop, and at most
    STOP_LAG replays run past the stop."""
    model = _model(dev, eos_bias=EOS_BIAS)
    graphed, uncaptured = _pair(model, geometry)
    T = GEOMETRIES[geometry][1]
    for seed in (3, 4):
        batch = _batch(seed)
        got = graphed.generate(batch)
        _same(got, uncaptured.generate(batch))
        assert graphed.last_steps == uncaptured.last_steps < T - 1
        assert 0 <= graphed.last_replays - graphed.last_steps <= STOP_LAG


def test_a_new_key_captures_again(dev):
    """After two batches of 32, a batch of 8 (a new key) captures its own
    graphs, and a batch of 32 after it captures again: each equals the
    uncaptured loop, at the retro geometry."""
    model = _model(dev)
    graphed, uncaptured = _pair(model, "retro")
    for n, (seed, rows) in enumerate(((5, B), (6, B), (7, 8), (8, B))):
        batch = _batch(seed, rows)
        got = graphed.generate(batch)
        assert (graphed.last_capture_ms > 0) == (n != 1)
        assert got[0].shape[0] == rows
        _same(got, uncaptured.generate(batch))


def test_a_replayed_batch_makes_no_host_wait(dev):
    """Once captured, a batch runs under sync_debug_mode 'error': the
    inputs go up and the beams come down through pinned buffers, and the
    stop flag is read behind events, so nothing synchronizes the card."""
    model = _model(dev, eos_bias=EOS_BIAS)
    graphed, _ = _pair(model, "rcr")
    graphed.generate(_batch(9))
    torch.cuda.set_sync_debug_mode("error")
    try:
        graphed.generate(_batch(10))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert graphed.last_capture_ms == 0


def test_counters_equal_the_kernels_a_trace_counts(dev):
    """The counters' launches of one replayed batch equal the attention,
    residual-LN and decode self-attention kernels that torch.profiler saw
    on the card."""
    from torch.profiler import ProfilerActivity, profile
    model = _model(dev)
    graphed, _ = _pair(model, "rcr")
    batch = _batch(11)
    graphed.generate(batch)
    before = _counts()
    decode_before = decode_attention.DECODE_LAUNCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graphed.generate(batch)
        torch.cuda.synchronize()
    after = _counts()
    names = [name for name, _, _ in device_events(prof)]
    seen = (sum("attention_fwd" in n for n in names),
            sum("residual_layernorm_fwd" in n for n in names))
    assert seen == (after[0] - before[0], after[1] - before[1])
    assert seen[1] == 2 * LAYERS + 3 * LAYERS * graphed.last_replays
    decode = sum("grouped_decode_attn" in n for n in names)
    assert decode == decode_attention.DECODE_LAUNCHES - decode_before
    assert decode == LAYERS * graphed.last_replays


# --- the train step ---------------------------------------------------------

TRAIN_ROWS, MICRO = 8, 4
DEC_VOCAB = 315


@pytest.fixture
def deterministic():
    with deterministic_algorithms():
        yield


def _train_model(dev) -> EncoderDecoder:
    kernels = dict(attention_impl="flash", layernorm_impl="fused")
    enc = SCIBERT_BASE.replace(num_hidden_layers=LAYERS, **kernels)
    dec = BERT_L6_DECODER.replace(num_hidden_layers=LAYERS,
                                  vocab_size=DEC_VOCAB, **kernels)
    assert enc.hidden_dropout_prob == enc.attention_probs_dropout_prob == 0.1
    model = EncoderDecoder(enc, dec, dtype=torch.bfloat16, mlm_layer="mlp")
    init_weights(model, torch.Generator().manual_seed(0))
    return model.to(dev)


def _trainer(dev, accumulate: bool = True, route: str = "cuda_graphs",
             lr: float = 1e-3):
    """(state, step) of a fresh model: every call draws the same weights."""
    model = _train_model(dev)
    cfg = dataclasses.replace(experiment("fused"), lr=lr, warmup_ratio=0.0,
                              max_grad_norm=1.0)
    opt = make_optimizer(cfg, 100, model.named_parameters())
    make = make_accum_train_step if accumulate else make_train_step
    step = make(model, cfg, opt, 0)
    assert step.route == "cuda_graphs"
    step.route = route
    return TrainState.create(model, opt), step


def _micro(seed: int, length: int = L, n: int = MICRO) -> dict:
    batches = [make_batch(TRAIN_ROWS, length, dec_vocab=DEC_VOCAB,
                          seed=seed * 10 + i) for i in range(n)]
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _state_tensors(state) -> dict:
    opt = state.optimizer
    out = {n: p.detach() for n, p in state.module.named_parameters()}
    out.update({f"exp_avg {n}": t for n, t in zip(opt.names, opt.exp_avg)})
    out.update({f"exp_avg_sq {n}": t
                for n, t in zip(opt.names, opt.exp_avg_sq)})
    return out


def _differing(a, b) -> dict:
    """{name: max |a - b| / max |b|} of the parameters and moments of two
    train states that are not equal to the bit."""
    ta, tb = _state_tensors(a), _state_tensors(b)
    return {n: float((ta[n] - tb[n]).abs().max()
                     / tb[n].abs().max().clamp(min=1e-30))
            for n in ta if not torch.equal(ta[n], tb[n])}


def _same_training(graphed, uncaptured) -> None:
    """Every parameter and both moments of the two states equal to the
    bit; the differing ones by name in the failure."""
    (g_state, _), (u_state, _) = graphed, uncaptured
    diff = _differing(g_state, u_state)
    assert not diff, diff
    assert g_state.step == u_state.step
    assert g_state.optimizer.count == u_state.optimizer.count


def _same_metrics(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), (k, float(got[k]),
                                              float(want[k]))


@pytest.mark.parametrize("accumulate", [True, False],
                         ids=["accumulation", "one_batch"])
def test_graphed_train_steps_equal_the_uncaptured_route(dev, deterministic,
                                                        accumulate):
    """Three steps (of four micro-batches, or of one batch): the graphed
    route's metrics after each step and its parameters and moments after
    the three equal the uncaptured route's to the bit, as two uncaptured
    runs equal each other. Every replay draws the masks of its own (seed,
    step, micro-batch), since the uncaptured route reseeds the same
    generator the same way."""
    graphed = _trainer(dev, accumulate)
    uncaptured = _trainer(dev, accumulate, route="uncaptured")
    again = _trainer(dev, accumulate, route="uncaptured")
    micro = _micro(1)
    weights = np.ones(MICRO, np.float32)
    for _ in range(3):
        outs = []
        for state, step in (graphed, uncaptured, again):
            if accumulate:
                outs.append(step(state, micro, weights, 5)[1])
            else:
                outs.append(step(state, {k: v[0] for k, v in micro.items()},
                                 5)[1])
        _same_metrics(outs[0], outs[1])
        _same_metrics(outs[1], outs[2])
    _same_training(again, uncaptured)
    _same_training(graphed, uncaptured)
    graphs = graphed[1].graphs
    (key,) = graphs.keys.values()
    assert key.micro.replays == (3 * MICRO - 1 if accumulate else 2)
    assert graphs.update.replays == 2
    assert graphs.update.capture_ms > 0 and key.micro.capture_ms > 0


def test_each_replay_takes_up_its_seed(dev, deterministic):
    """At rate 0 the weights stay: the same step counter replays the same
    masks to the bit, another counter draws others, so the replays' masks
    follow the generator's seed at each replay, not the capture's."""
    state, step = _trainer(dev, lr=0.0)
    micro, weights = _micro(2), np.ones(MICRO, np.float32)
    losses = []
    for counter in (0, 0, 1, 0):
        state.step = counter
        losses.append(step(state, micro, weights, 5)[1]["train_loss"])
    assert step.graphs.update.replays == 3
    assert torch.equal(losses[0], losses[1])
    assert torch.equal(losses[1], losses[3])
    assert not torch.equal(losses[1], losses[2])


def test_a_weight_zero_pad_gives_the_update_of_the_real_batches(
        dev, deterministic):
    """Three real micro-batches and a weight-0 pad give the update of the
    three alone, to the bit, over two graphed steps."""
    padded, alone = _trainer(dev), _trainer(dev)
    micro = _micro(3)
    for _ in range(2):
        got = padded[1](padded[0], micro, np.array([1, 1, 1, 0], np.float32),
                        5)[1]
        want = alone[1](alone[0], {k: v[:3] for k, v in micro.items()},
                        np.ones(3, np.float32), 5)[1]
        _same_metrics(got, want)
    _same_training(padded, alone)


def test_two_keys_alternate_through_their_graphs(dev, deterministic):
    """Micro-batches at L=512 and at L=256 in turn: each key captures once
    and replays after, and every step equals the uncaptured route's to the
    bit."""
    graphed = _trainer(dev)
    uncaptured = _trainer(dev, route="uncaptured")
    weights = np.ones(MICRO, np.float32)
    for n, length in enumerate((L, L // 2, L, L // 2)):
        micro = _micro(4 + n, length)
        outs = [step(state, micro, weights, 5)[1]
                for state, step in (graphed, uncaptured)]
        _same_metrics(*outs)
    _same_training(graphed, uncaptured)
    keys = list(graphed[1].graphs.keys.values())
    assert len(keys) == 2
    assert [k.micro.replays for k in keys] == [2 * MICRO - 1] * 2


def test_a_replayed_train_step_makes_no_host_wait(dev):
    """Once captured, a step runs under sync_debug_mode 'error': the
    inputs go up through pinned memory, the weight, the weight sum and the
    rate are written by kernels, and the metrics come back as tensors."""
    state, step = _trainer(dev)
    micro, weights = _micro(5), np.ones(MICRO, np.float32)
    step(state, micro, weights, 5)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, metrics = step(state, micro, weights, 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert step.graphs.update.replays == 1
    assert torch.isfinite(metrics["train_loss"]).item()


def test_train_counters_equal_the_kernels_a_trace_counts(dev):
    """The counters' launches of one replayed step equal the attention and
    residual-LN kernels that torch.profiler saw on the card: per
    micro-batch the encoder's attention forward and backward a layer, and
    two LNs an encoder layer and three a decoder layer, each way."""
    from torch.profiler import ProfilerActivity, profile
    state, step = _trainer(dev)
    micro, weights = _micro(6), np.ones(MICRO, np.float32)
    step(state, micro, weights, 5)
    torch.cuda.synchronize()
    counters = lambda: (fused_attention.LAUNCHES,  # noqa: E731
                        fused_attention.BWD_LAUNCHES,
                        fused_layernorm.LAUNCHES,
                        fused_layernorm.BWD_LAUNCHES)
    before = counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, micro, weights, 5)
        torch.cuda.synchronize()
    counted = tuple(a - b for a, b in zip(counters(), before))
    names = [name for name, _, _ in device_events(prof)]
    seen = tuple(sum(fragment in n for n in names) for fragment in (
        "attention_fwd", "attention_bwd_dq", "residual_layernorm_fwd",
        "residual_layernorm_bwd"))
    ln = (2 * LAYERS + 3 * LAYERS) * MICRO
    assert counted == (LAYERS * MICRO, LAYERS * MICRO, ln, ln)
    assert seen == counted


# --- the eval step ----------------------------------------------------------

EDITS, ATOM_CLASSES, BOND_CLASSES = 500, 400, 60
ATOMS, BONDS = 48, 104   # a batch's padded atoms and bond slots


def _eval_pair(model, cfg, edit_topk: int = 1):
    """(the graphed eval step, the uncaptured one) on the same weights."""
    graphed = make_eval_step(model, cfg, 0, edit_topk=edit_topk)
    uncaptured = make_eval_step(model, cfg, 0, edit_topk=edit_topk)
    assert graphed.route == "cuda_graphs"
    uncaptured.route = "uncaptured"
    return graphed, uncaptured


def _rcr_eval(seed: int, length: int = L, rows: int = B) -> dict:
    """bench_train's batch with a ragged key mask."""
    batch = make_batch(rows, length, dec_vocab=DEC_VOCAB, seed=seed)
    batch["attention_mask"] = _batch(seed, rows)["attention_mask"][:, :length]
    return batch


def _template_model(dev) -> TemplateBasedModel:
    enc = SCIBERT_BASE.replace(num_hidden_layers=LAYERS,
                               attention_impl="flash",
                               layernorm_impl="fused")
    model = TemplateBasedModel(enc, ATOM_CLASSES, BOND_CLASSES,
                               dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(0))
    return model.to(dev)


def _template_eval(seed: int, rows: int = B) -> dict:
    """The collator's arrays of `rows` products: atom tokens after [CLS],
    bonds between random atoms, a label or two an example, and the (L, L)
    bond mask of RetrosynthesisDataset._bond_mask."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(ATOMS + 16, L + 1, rows)
    n_atoms = rng.integers(ATOMS // 2, ATOMS + 1, rows)
    n_bonds = rng.integers(BONDS // 2, BONDS + 1, rows)
    key = np.arange(L)[None] < lengths[:, None]
    out = {"input_ids": (rng.integers(100, SCIBERT_BASE.vocab_size, (rows, L))
                         * key).astype(np.int32),
           "attention_mask": np.zeros((rows, L, L), np.int32),
           "atom_indices": np.zeros((rows, ATOMS), np.int32),
           "atom_mask": np.zeros((rows, ATOMS), np.int32),
           "bond_pairs": np.zeros((rows, BONDS, 2), np.int32),
           "bond_mask": np.zeros((rows, BONDS), np.int32),
           "atom_template_labels": np.full((rows, ATOMS), IGNORE_INDEX,
                                           np.int32),
           "bond_template_labels": np.full((rows, BONDS), IGNORE_INDEX,
                                           np.int32),
           "example_mask": np.ones((rows,), np.int32),
           "indices": np.arange(rows, dtype=np.int32)}
    for b in range(rows):
        n, m = int(n_atoms[b]), int(n_bonds[b])
        pairs = rng.integers(0, n, (m, 2))
        keep = np.eye(n, dtype=np.int32)
        keep[pairs[:, 0], pairs[:, 1]] = 1
        mask = np.ones((lengths[b], lengths[b]), np.int32)
        mask[1:n + 1, 1:n + 1] = keep
        out["attention_mask"][b, :lengths[b], :lengths[b]] = mask
        out["atom_indices"][b, :n] = np.arange(1, n + 1)
        out["atom_mask"][b, :n] = 1
        out["bond_pairs"][b, :m] = pairs
        out["bond_mask"][b, :m] = 1
        out["atom_template_labels"][b, :n] = 0
        out["atom_template_labels"][b, rng.integers(n)] = rng.integers(
            1, ATOM_CLASSES + 1)
        out["bond_template_labels"][b, :m] = 0
        out["bond_template_labels"][b, rng.integers(m)] = rng.integers(
            1, BOND_CLASSES + 1)
    return out


def _same_results(got: dict, want: dict) -> None:
    """Every output of two eval calls equal to the bit."""
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


EVAL_PATHS = {
    # path -> (model, config, top k, batch, launches of attention and of
    # residual LN a call)
    "rcr": (_train_model, lambda: experiment("fused"), 1, _rcr_eval,
            (LAYERS, 5 * LAYERS)),
    "template": (_template_model, lambda: ExperimentConfig(
        task="retro", template_based=True, unattend_nonbonds=True,
        template_path="x"), EDITS, _template_eval, (LAYERS, 2 * LAYERS)),
}


@pytest.mark.parametrize("path", sorted(EVAL_PATHS))
def test_graphed_eval_equals_the_uncaptured_route(dev, path):
    """Two batches of one key: the first captures, the second replays;
    each equals the uncaptured route on its batch to the bit, the two
    batches' results differ, the first result is left as it was by the
    second call, the output buffers keep their storage, and the counters
    count the kernels the card ran (under the bond mask the packed-mask
    kernels, a forward a layer)."""
    make_model, make_cfg, k, make, launches = EVAL_PATHS[path]
    graphed, uncaptured = _eval_pair(make_model(dev), make_cfg(), k)
    results = []
    for n, seed in enumerate((1, 2)):
        batch = make(seed)
        before = _counts()
        got = graphed(batch)
        after = _counts()
        assert (after[0] - before[0], after[1] - before[1]) == launches
        (key,) = graphed.graphs.keys.values()
        assert key.forward.replays == n and key.forward.capture_ms > 0
        if n == 0:
            kept = {name: t.clone() for name, t in got.items()}
            pointers = [t.data_ptr() for t in key.outputs.values()]
        assert [t.data_ptr() for t in key.outputs.values()] == pointers
        _same_results(got, uncaptured(batch))
        results.append(got)
    _same_results(results[0], kept)
    assert not torch.equal(results[0]["loss"], results[1]["loss"])
    if path == "template":
        assert results[0]["atom_topk_idx"].shape == (B, EDITS)
        assert (results[0]["bond_topk_vals"][:, -1] >= 0).all()


def test_eval_keys_alternate_and_a_new_key_captures(dev):
    """Batches at L=512 and at L=256 in turn, then 8 rows (a new key) and
    512 again: a key captures at its first call only, and every call
    equals the uncaptured route to the bit."""
    graphed, uncaptured = _eval_pair(_train_model(dev), experiment("fused"))
    shapes = ((L, B), (L // 2, B), (L, B), (L // 2, B), (L, 8), (L, B))
    for n, (length, rows) in enumerate(shapes):
        batch = _rcr_eval(20 + n, length, rows)
        keys = 0 if graphed.graphs is None else len(graphed.graphs.keys)
        got = graphed(batch)
        assert len(graphed.graphs.keys) - keys == (n in (0, 1, 4))
        _same_results(got, uncaptured(batch))
    parts = list(graphed.graphs.keys.values())
    assert [p.forward.replays for p in parts] == [2, 1, 0]


def test_a_replayed_eval_step_makes_no_host_wait(dev):
    """Once captured, a call runs under sync_debug_mode 'error': the batch
    goes up through pinned memory and the results come back as tensors on
    the card; the caller's read is the one wait."""
    graphed, _ = _eval_pair(_template_model(dev), EVAL_PATHS["template"][1](),
                            EDITS)
    graphed(_template_eval(3))
    batch = _template_eval(4)
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = graphed(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    (key,) = graphed.graphs.keys.values()
    assert key.forward.replays == 1
    assert torch.isfinite(res["loss"]).all().item()


def test_eval_counters_equal_the_kernels_a_trace_counts(dev):
    """The counters' launches of one replayed RCR eval call equal the
    attention and residual-LN kernels that torch.profiler saw: the
    encoder's attention a layer, two LNs an encoder layer and three a
    decoder layer, no backward."""
    from torch.profiler import ProfilerActivity, profile
    graphed, _ = _eval_pair(_train_model(dev), experiment("fused"))
    batch = _rcr_eval(5)
    graphed(batch)
    torch.cuda.synchronize()
    before = _counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graphed(batch)
        torch.cuda.synchronize()
    counted = tuple(a - b for a, b in zip(_counts(), before))
    names = [name for name, _, _ in device_events(prof)]
    seen = tuple(sum(fragment in n for n in names) for fragment in (
        "attention_fwd", "residual_layernorm_fwd"))
    assert counted == seen == (LAYERS, 5 * LAYERS)
    assert not any("_bwd" in n for n in names)


def test_a_validation_between_train_keys_leaves_the_next_capture_right(
        dev, deterministic):
    """A graphed train step at L=512, a graphed validation (the module in
    eval mode, its forward captured), then the first step of a new key
    (L=256, captured after the validation) and one more of each key: every
    metric, parameter and moment equals a graphed run that made no
    validation and an uncaptured run that made it, to the bit; the
    validations of the two runs that made them are equal too."""
    runs = {name: _trainer(dev, route=route) for name, route in (
        ("graphed", "cuda_graphs"), ("quiet", "cuda_graphs"),
        ("uncaptured", "uncaptured"))}
    cfg = experiment("fused")
    evals = {name: make_eval_step(runs[name][0].module, cfg, 0)
             for name in ("graphed", "uncaptured")}
    evals["uncaptured"].route = "uncaptured"
    weights = np.ones(MICRO, np.float32)
    scores = {}
    for n, length in enumerate((L, L // 2, L, L // 2)):
        micro = _micro(30 + n, length)
        outs = {}
        for name, (state, step) in runs.items():
            outs[name] = step(state, micro, weights, 5)[1]
            assert state.module.training
            if name in evals and n == 0:
                scores[name] = evals[name](_rcr_eval(7))
                assert not state.module.training
        _same_metrics(outs["graphed"], outs["quiet"])
        _same_metrics(outs["graphed"], outs["uncaptured"])
    _same_results(scores["graphed"], scores["uncaptured"])
    _same_training(runs["graphed"], runs["quiet"])
    _same_training(runs["graphed"], runs["uncaptured"])
    assert len(runs["graphed"][1].graphs.keys) == 2
