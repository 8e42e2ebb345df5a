"""The grouped beam decode's self-attention op (ops/decode_attention.py).

On the CPU: the plain version that `decode_self_grouped` now calls gives,
to the bit, what the layer's own body computed before the op existed (its
lines are kept below as `_layer_body_before`); the wrapper raises off the
card; the launch counter is one of `KERNEL_COUNTERS`; no kernel of
csrc/decode_attention.cu is named after a kernel the benchmark's trace
matches against the other counters; a decoder whose head dim the kernel
does not take is refused when the model is built.

On the card (`cuda` marker; skips from a fixture without a GPU): the kernel
against the plain version and against a float64 reference, over the
retro and RCR geometries' windows in a cache longer than the window (the
prefix read in place at the cache's row stride), both score dtypes, bf16
and f32 operands, biases from `ancestor_bias` at several lengths; odd
shapes (unaligned rows, a ragged last tile, more than 32 beams, head dims
from 8 to 128 at and between the kernel's widths, an unaligned q); no host
wait inside a call. On the GPU machine:

    python -m pytest tests/test_torch_decode_attention.py -q -m cuda
"""

import _torch_threads  # noqa: F401  (before torch runs)
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.trace import PORT_KERNELS
from textreact_tpu_torch.inference.beam import ancestor_bias
from textreact_tpu_torch.models import TransformerConfig
from textreact_tpu_torch.models.factory import check_kernel_shapes
from textreact_tpu_torch.models.layers import MultiHeadAttention
from textreact_tpu_torch.ops import decode_attention, launches
from textreact_tpu_torch.ops.decode_attention import (
    MAX_HEAD_DIM, grouped_decode_attention,
    grouped_decode_attention_reference)

SOURCE = (Path(decode_attention.__file__).resolve().parent.parent / "csrc"
          / "decode_attention.cu")


def _bias(rng, B, G, W, cur_len, device="cpu") -> torch.Tensor:
    """ancestor_bias of a random ancestor table at `cur_len`."""
    src = torch.as_tensor(rng.integers(0, G, (B, G, W)), device=device)
    return ancestor_bias(src, cur_len, B, G, W)


# --- the CPU ----------------------------------------------------------------

def _layer_body_before(attn, x, cache_k, cache_v, position, beam_bias):
    """MultiHeadAttention.decode_self_grouped as it read before the op
    (its CPU route: products through f32 up-casts)."""
    cfg = attn.config
    H, D = attn.num_heads, cfg.head_dim
    Bex = cache_k.shape[0]
    G = x.shape[0] // Bex
    WG = beam_bias.shape[-1]
    at = torch.full((1,), position, dtype=torch.long)
    T = cache_k.shape[-1] // G
    cache_k.view(Bex, H, D, T, G).index_copy_(3, at, attn.key(x).view(
        Bex, G, H, D).permute(0, 2, 3, 1)[:, :, :, None])
    cache_v.view(Bex, H, D, T, G).index_copy_(3, at, attn.value(
        x).view(Bex, G, H, D).permute(0, 2, 3, 1)[:, :, :, None])
    q = attn.query(x).view(Bex, G, H, D).transpose(1, 2).reshape(
        Bex * H, G, D)
    k = cache_k[..., :WG].view(Bex * H, D, WG)
    v = cache_v[..., :WG].view(Bex * H, D, WG)
    s_dt = (torch.float32 if cfg.decode_scores_dtype == "float32"
            else attn.dtype)
    s = torch.matmul(q.float(), k.float()).to(s_dt).view(Bex, H, G, WG)
    s = s.float() * (1.0 / math.sqrt(D)) + beam_bias[:, None]
    probs = torch.softmax(s, dim=-1).to(attn.dtype)
    ctx = torch.matmul(probs.view(Bex * H, G, WG).float(),
                       v.transpose(1, 2).float()).to(attn.dtype)
    return attn._out(ctx.view(Bex, H, G, D).transpose(1, 2).reshape(
        Bex * G, 1, H * D))


@pytest.mark.parametrize("scores", ["bfloat16", "float32"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G,T,W", [(3, 8, 8), (5, 16, 8)])
def test_the_layer_gives_what_it_gave_before_the_op(dtype, scores, G, T, W):
    """decode_self_grouped on the CPU (the plain version) against the
    layer's former body, on the same weights and inputs: equal to the bit,
    output and both caches."""
    config = TransformerConfig(hidden_size=64, num_attention_heads=4,
                               intermediate_size=128, is_decoder=True,
                               decode_scores_dtype=scores)
    torch.manual_seed(G * T)
    attn = MultiHeadAttention(config, dtype).eval()
    rng = np.random.default_rng(G + T)
    Bex, H, D = 2, 4, 16
    x = torch.randn(Bex * G, 1, 64).to(dtype)
    cache = [torch.randn(Bex, H, D, T * G).to(dtype) for _ in range(2)]
    for position in (0, W // 2, W - 1):
        bias = _bias(rng, Bex, G, W, position + 1)
        k_new, v_new = (c.clone() for c in cache)
        k_old, v_old = (c.clone() for c in cache)
        with torch.no_grad():
            got = attn.decode_self_grouped(x, k_new, v_new, position, bias)
            want = _layer_body_before(attn, x, k_old, v_old, position, bias)
        assert got.dtype == want.dtype == dtype
        assert torch.equal(got, want)
        assert torch.equal(k_new, k_old) and torch.equal(v_new, v_old)


def test_the_wrapper_raises_off_the_card():
    rng = np.random.default_rng(0)
    q = torch.randn(2 * 4, 3, 16)
    cache = torch.zeros(2, 4, 16, 24)
    bias = _bias(rng, 2, 3, 8, 2)
    with pytest.raises(ValueError, match="reference"):
        grouped_decode_attention(q, cache, cache, bias, 0.25, True)
    # the plain version takes the same arguments
    assert grouped_decode_attention_reference(
        q, cache, cache, bias, 0.25, True).shape == q.shape


def test_the_counter_is_one_of_the_kernel_counters():
    """GraphLaunches takes a capture's launches of the op back and adds
    them at each replay."""
    assert (decode_attention, "DECODE_LAUNCHES") in launches.KERNEL_COUNTERS
    gl = launches.GraphLaunches()
    before = decode_attention.DECODE_LAUNCHES
    with gl.capturing():
        decode_attention.DECODE_LAUNCHES += 6
    assert decode_attention.DECODE_LAUNCHES == before
    gl.replayed(3)
    assert decode_attention.DECODE_LAUNCHES == before + 18


def test_no_kernel_is_named_after_a_port_kernel():
    """A traced benchmark run counts kernels whose names hold one of
    PORT_KERNELS' fragments against the other wrappers' counters."""
    text = SOURCE.read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                       r"(\w+)\s*\(", text)
    assert names == ["grouped_decode_attn_mma", "grouped_decode_attn_exact"]
    for name in names:
        for fragment, _ in PORT_KERNELS:
            assert fragment not in name


@pytest.mark.parametrize("hidden,heads", [
    (96, 12), (384, 12), (576, 12), (768, 12), (960, 12), (1152, 12),
    (300, 3), (1536, 12), (1632, 12), (2048, 8)],
    ids=["d8", "d32", "d48", "d64", "d80", "d96", "d100", "d128", "d136",
         "d256"])
def test_a_decoder_is_refused_past_the_kernels_head_dim(hidden, heads):
    """build_model checks a decoder that beam search runs with decode=True:
    head dims up to MAX_HEAD_DIM pass (the kernel's routes take any of
    them), wider ones are refused before any batch. Without decode (a stack
    that only trains) the decode kernel's rule does not apply."""
    cfg = TransformerConfig(hidden_size=hidden, num_attention_heads=heads,
                            intermediate_size=4 * hidden, is_decoder=True,
                            attention_impl="xla", layernorm_impl="xla")
    check_kernel_shapes(cfg, attention=False)
    if cfg.head_dim <= MAX_HEAD_DIM:
        check_kernel_shapes(cfg, attention=False, decode=True)
    else:
        with pytest.raises(ValueError, match="decode attention kernel"):
            check_kernel_shapes(cfg, attention=False, decode=True)


# --- the card ---------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _inputs(dev, dtype, Bex, H, G, D, T, W, cur_len, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(Bex * H, G, D, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(Bex, H, D, T * G, generator=g, device=dev).to(dtype)
            for _ in range(2))
    bias = _bias(np.random.default_rng(seed), Bex, G, W, cur_len, dev)
    return q, k, v, bias


def _f64(q, k, v, bias, scale):
    Bex, H, D = k.shape[:3]
    G, WG = q.shape[1], bias.shape[-1]
    kk = k[..., :WG].double().reshape(Bex * H, D, WG)
    vv = v[..., :WG].double().reshape(Bex * H, D, WG)
    s = torch.bmm(q.double(), kk).view(Bex, H, G, WG) * scale
    p = torch.softmax(s + bias.double()[:, None], -1).view(Bex * H, G, WG)
    return torch.bmm(p, vv.transpose(1, 2))


# (Bex, H, G, D, T, W): retro's three windows and RCR's one
GEOMETRIES = [(32, 12, 20, 64, 160, 48), (32, 12, 20, 64, 160, 80),
              (32, 12, 20, 64, 160, 160), (32, 12, 15, 64, 32, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("round_scores", [True, False])
@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=["retro48", "retro80", "retro160", "rcr16"])
def test_kernel_against_the_plain_version_and_float64(dev, dtype,
                                                      round_scores,
                                                      geometry):
    """At several lengths in the window: close to the plain version, and
    no further from float64 than 1.25 times the plain version is."""
    Bex, H, G, D, T, W = geometry
    scale = 1.0 / math.sqrt(D)
    for cur_len in sorted({1, W // 3 + 1, W - 1, W}):
        q, k, v, bias = _inputs(dev, dtype, Bex, H, G, D, T, W, cur_len,
                                seed=W * 1000 + cur_len)
        before = decode_attention.DECODE_LAUNCHES
        got = grouped_decode_attention(q, k, v, bias, scale, round_scores)
        torch.cuda.synchronize()
        assert decode_attention.DECODE_LAUNCHES == before + 1
        plain = grouped_decode_attention_reference(q, k, v, bias, scale,
                                                   round_scores)
        assert got.dtype == dtype and torch.isfinite(got).all()
        exact = _f64(q, k, v, bias, scale)
        err = (got.double() - exact).abs().max().item()
        plain_err = (plain.double() - exact).abs().max().item()
        assert err <= 1.25 * plain_err, (cur_len, err, plain_err)
        atol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        diff = (got.float() - plain.float()).abs().max().item()
        assert diff <= atol, (cur_len, diff)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Bex,H,G,D,T,W", [
    (1, 12, 20, 64, 160, 160),   # one example: a part of one wave
    (2, 2, 3, 64, 7, 7),         # rows of 21 keys: no 16-byte copies
    (3, 2, 5, 64, 9, 4),         # a ragged last tile in an odd stride
    (2, 3, 40, 64, 12, 12),      # two row groups
    (2, 4, 20, 32, 48, 48),      # head dims of the other widths
    (2, 2, 20, 128, 48, 48),
    # head dims between the widths (the columns past D held at zero), at
    # 32 examples: the maximum error over a few thousand bf16 outputs is
    # one output's rounding, and the plain version's is no steadier
    (32, 3, 20, 8, 48, 48),
    (32, 3, 20, 48, 48, 48),
    (32, 3, 15, 80, 32, 16),
    (32, 3, 20, 96, 48, 48),
    (32, 3, 20, 100, 48, 48),    # no multiple of 8: Q rows by elements
    (32, 3, 20, 36, 48, 48),
])
def test_kernel_at_odd_shapes(dev, dtype, Bex, H, G, D, T, W):
    scale = 1.0 / math.sqrt(D)
    q, k, v, bias = _inputs(dev, dtype, Bex, H, G, D, T, W, (W + 1) // 2,
                            seed=Bex + H + G + D + T + W)
    for _ in range(2):  # the same launch again gives the same result
        got = grouped_decode_attention(q, k, v, bias, scale, True)
        plain = grouped_decode_attention_reference(q, k, v, bias, scale,
                                                   True)
        exact = _f64(q, k, v, bias, scale)
        err = (got.double() - exact).abs().max().item()
        plain_err = (plain.double() - exact).abs().max().item()
        assert err <= 1.25 * plain_err + 1e-6, (err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 48])
def test_kernel_reads_an_unaligned_q(dev, D):
    """q contiguous at an address off 16 bytes: the bf16 route reads its
    rows by elements and gives what it gives on an aligned copy."""
    Bex, H, G, T, W = 2, 3, 20, 48, 48
    q, k, v, bias = _inputs(dev, torch.bfloat16, Bex, H, G, D, T, W, 30,
                            seed=D)
    store = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    q_off = store[1:].view(q.shape)
    q_off.copy_(q)
    assert q_off.is_contiguous() and q_off.data_ptr() % 16 != 0
    scale = 1.0 / math.sqrt(D)
    got = grouped_decode_attention(q_off, k, v, bias, scale, True)
    want = grouped_decode_attention(q, k, v, bias, scale, True)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_a_call_makes_no_host_wait(dev):
    q, k, v, bias = _inputs(dev, torch.bfloat16, 1, 12, 20, 64, 160, 160, 90,
                            seed=3)
    grouped_decode_attention(q, k, v, bias, 0.125, True)  # built, planned
    torch.cuda.set_sync_debug_mode("error")
    try:
        grouped_decode_attention(q, k, v, bias, 0.125, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
