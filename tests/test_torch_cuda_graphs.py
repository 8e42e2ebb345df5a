"""The Generator's CUDA graphs against the uncaptured device-state loop, on
the card.

Two-layer encoder and decoder at the RCR recipe's widths (SciBERT-base and
bert_l6: hidden 768 in 12 heads, bf16 weights, 32 requests of 512 tokens),
decoding at beam 15 over 16 positions (one window) and at the retro
geometry, beam 20 over 160 positions (the windows 48, 80, 160). Each
compares the graphed route with the same weights' uncaptured loop
(`Generator.route = "uncaptured"`) to the bit: on two batches through the
same graphs, on batches that stop early under an lm-head bias that
favours EOS, and on a new key after them. Every test needs a GPU: it
carries the `cuda` marker and skips (from a fixture) without one. On the
GPU machine:

    python -m pytest tests/test_torch_cuda_graphs.py -q -m cuda
"""

import _torch_threads  # noqa: F401  (before torch runs)
import numpy as np
import pytest
import torch

from chip_smoke import device_events
from textreact_tpu_torch.inference import Generator
from textreact_tpu_torch.inference.beam import STOP_LAG
from textreact_tpu_torch.models import EncoderDecoder
from textreact_tpu_torch.models.config import BERT_L6_DECODER, SCIBERT_BASE
from textreact_tpu_torch.models.factory import init_weights
from textreact_tpu_torch.ops import fused_attention, fused_layernorm

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
    decoder layer each replay."""
    model = _model(dev)
    graphed, uncaptured = _pair(model, geometry)
    batches = [_batch(1), _batch(2)]
    results = []
    for n, batch in enumerate(batches):
        before = _counts()
        got = graphed.generate(batch)
        after = _counts()
        assert (graphed.last_capture_ms > 0) == (n == 0)
        assert after[0] - before[0] == LAYERS
        assert after[1] - before[1] == (2 * LAYERS
                                        + 3 * LAYERS * graphed.last_replays)
        if n == 0:
            pointers = _cache_pointers(graphed)
        assert _cache_pointers(graphed) == pointers
        _same(got, uncaptured.generate(batch))
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
    """The counters' launches of one replayed batch equal the attention
    and residual-LN kernels that torch.profiler saw on the card."""
    from torch.profiler import ProfilerActivity, profile
    model = _model(dev)
    graphed, _ = _pair(model, "rcr")
    batch = _batch(11)
    graphed.generate(batch)
    before = _counts()
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
