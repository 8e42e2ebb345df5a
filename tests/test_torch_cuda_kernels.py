"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs a GPU: it carries
the `cuda` marker and skips (from a fixture, never at import) where
`torch.cuda.is_available()` is false. On the GPU machine:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda
"""

import _torch_threads  # noqa: F401  (before torch runs)
import numpy as np
import pytest
import torch

from chip_smoke import (attention_probe_inputs, drawn_seed,
                        ragged_holes_mask)
from textreact_tpu_torch.inference import Generator
from textreact_tpu_torch.models import EncoderDecoder, TransformerConfig
from textreact_tpu_torch.models.factory import init_weights
from textreact_tpu_torch.ops import fused_attention, fused_layernorm, topk
from textreact_tpu_torch.retrieval import FlatIndex

pytestmark = pytest.mark.cuda

# kernel vs plain on the same card. f32: summation order only. bf16: both
# compute in f32 and round the result to bf16 (the plain attention also
# rounds its probabilities to bf16), so they may differ by one bf16 ulp
ATTN_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2e-2, 0.0)}
LN_TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (1.6e-2, 2.0 ** -7)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, atol, rtol):
    diff = (got.float() - ref.float()).abs()
    assert (diff <= atol + rtol * ref.float().abs()).all(), float(diff.max())


def _mask(B, L, dev, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, B)
    lengths[-1] = 0  # dummy row: every key masked
    return torch.as_tensor(np.arange(L)[None] < lengths[:, None],
                           dtype=torch.int32, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,H,D", [(128, 2, 64), (256, 4, 32), (512, 12, 64),
                                   (256, 2, 128)])
@pytest.mark.parametrize("masked", [True, False])
def test_attention_kernel_matches_plain(dev, dtype, L, H, D, masked):
    B = 3
    g = torch.Generator(device=dev).manual_seed(L + D)
    q, k, v = (torch.randn(B, L, H, D, generator=g, device=dev).to(dtype)
               for _ in range(3))
    mask = _mask(B, L, dev) if masked else None
    before = fused_attention.LAUNCHES
    got = fused_attention.fused_dropout_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert fused_attention.LAUNCHES == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    ref = fused_attention.attention_reference(q, k, v, mask, D ** -0.5)
    _close(got, ref, *ATTN_TOL[dtype])


def test_attention_kernel_raises_on_what_it_does_not_take(dev):
    q = torch.randn(2, 128, 2, 64, device=dev)
    with pytest.raises(ValueError):  # an explicit mask is for CPU tensors
        fused_attention.fused_dropout_attention(
            q, q, q, None, 0.1, keep=torch.ones(2, 2, 128, 128, device=dev))
    with pytest.raises(ValueError):
        x = torch.randn(2, 100, 2, 64, device=dev)
        fused_attention.fused_dropout_attention(x, x, x, None)
    for D in (100, 136):   # head dims: multiples of 8 up to 128
        with pytest.raises(ValueError):
            x = torch.randn(2, 128, 1, D, device=dev)
            fused_attention.fused_dropout_attention(x, x, x, None)
    with pytest.raises(ValueError):
        x = torch.randn(2, 2, 128, 64, device=dev).transpose(1, 2)
        fused_attention.fused_dropout_attention(x, x, x, None)
    with pytest.raises(TypeError):
        x = q.half()
        fused_attention.fused_dropout_attention(x, x, x, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", fused_layernorm.REGISTER_HIDDEN)
@pytest.mark.parametrize("R", [1, 7, 480])
def test_layernorm_kernel_matches_plain(dev, dtype, H, R):
    g = torch.Generator(device=dev).manual_seed(R * H)
    x, y = (torch.randn(R, H, generator=g, device=dev).to(dtype)
            for _ in range(2))
    w = 1.0 + 0.1 * torch.randn(H, generator=g, device=dev)
    b = 0.1 * torch.randn(H, generator=g, device=dev)
    before = fused_layernorm.LAUNCHES
    got = fused_layernorm.fused_residual_layernorm(x, y, w, b, 1e-5)
    torch.cuda.synchronize()
    assert fused_layernorm.LAUNCHES == before + 1
    ref = fused_layernorm.residual_layernorm_reference(x, y, w, b, 1e-5)
    _close(got, ref, *LN_TOL[dtype])


def test_layernorm_kernel_raises_on_what_it_does_not_take(dev):
    x = torch.randn(4, 768, device=dev)
    w, b = torch.ones(768, device=dev), torch.zeros(768, device=dev)
    with pytest.raises(ValueError):  # an explicit mask is for CPU tensors
        fused_layernorm.fused_residual_layernorm(
            x, x, w, b, 1e-5, 0.1, keep=torch.ones_like(x, dtype=torch.bool))
    with pytest.raises(ValueError):
        z = torch.randn(4, 100, device=dev)
        fused_layernorm.fused_residual_layernorm(z, z, w[:100], b[:100])
    with pytest.raises(ValueError):
        fused_layernorm.fused_residual_layernorm(x, x, w.bfloat16(), b)
    with pytest.raises(ValueError):
        fused_layernorm.fused_residual_layernorm(x, x.bfloat16(), w, b)


# gradients, kernel vs autograd through the plain version with the exported
# keep mask. f32: summation order only (sums of up to 512 terms of size
# ~1). bf16: each side rounds its f32 gradient to bf16 (half an ulp, 2^-9
# relative, each) and the plain attention also rounds its weights to bf16
# before they meet v
GRAD_TOL = {torch.float32: (2e-4, 1e-4), torch.bfloat16: (3e-2, 2.0 ** -6)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,H,D", [(128, 2, 64), (256, 4, 32), (512, 3, 64),
                                   (256, 2, 128)])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_attention_kernel_forward_and_gradients_match_plain(dev, dtype, L, H,
                                                            D, p):
    B = 3
    g = torch.Generator(device=dev).manual_seed(L + D)
    q, k, v, do = (torch.randn(B, L, H, D, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    mask = _mask(B, L, dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = fused_attention.LAUNCHES, fused_attention.BWD_LAUNCHES
    state = g.get_state()
    got = fused_attention.fused_dropout_attention(*leaves, mask, p, g)
    got.backward(do)
    assert fused_attention.LAUNCHES == fwd + 1
    assert fused_attention.BWD_LAUNCHES == bwd + 1
    keep = None
    if p > 0.0:
        g.set_state(state)  # the seed the wrapper drew
        seed = torch.randint(0, 1 << 62, (1,), generator=g, device=dev,
                             dtype=torch.int64)
        keep = fused_attention.keep_mask(seed, B, H, L, p)
        assert abs(float(keep.float().mean()) - (1 - p)) < 0.01
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = fused_attention.attention_reference(*ref_leaves, mask, D ** -0.5,
                                              keep, p)
    ref.backward(do)
    _close(got, ref, *ATTN_TOL[dtype])
    for a, b in zip(leaves, ref_leaves):
        assert torch.isfinite(a.grad).all()
        _close(a.grad, b.grad, *GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [96, 48, 8, 120])
@pytest.mark.parametrize("causal,p", [(False, 0.0), (False, 0.1),
                                      (True, 0.0)])
def test_padded_head_dims_match_plain(dev, dtype, D, causal, p):
    """A head dim that is no instantiated width runs the next one's kernels
    on zero-padded q, k, v (PADDED_LAUNCHES): output and gradients equal the
    plain version's at the true D, with the scale of the true D and the
    masks of the unpadded call."""
    B, L, H = 3, 256, 2
    g = torch.Generator(device=dev).manual_seed(L + D)
    q, k, v, do = (torch.randn(B, L, H, D, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    mask = _mask(B, L, dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kind = "causal_" if causal else ""
    before = dict(fused_attention.PADDED_LAUNCHES)
    state = g.get_state()
    if causal:
        got = fused_attention.causal_attention(*leaves, mask)
    else:
        got = fused_attention.fused_dropout_attention(*leaves, mask, p, g)
    got.backward(do)
    assert got.shape == q.shape and got.is_contiguous()
    assert fused_attention.PADDED_LAUNCHES[kind + "fwd"] \
        == before[kind + "fwd"] + 1
    assert fused_attention.PADDED_LAUNCHES[kind + "bwd"] \
        == before[kind + "bwd"] + 1
    keep = None
    if p > 0.0:
        keep = fused_attention.keep_mask(drawn_seed(g, state), B, H, L, p)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = fused_attention.attention_reference(*ref_leaves, mask, D ** -0.5,
                                              keep, p, causal=causal)
    ref.backward(do)
    _close(got, ref, *ATTN_TOL[dtype])
    for a, b in zip(leaves, ref_leaves):
        assert a.grad.shape == q.shape and torch.isfinite(a.grad).all()
        _close(a.grad, b.grad, *GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 40, 48, 96, 120])
@pytest.mark.parametrize("causal,p", [(False, 0.0), (False, 0.1),
                                      (True, 0.0)])
def test_true_head_dim_equals_the_padded_call_to_the_bit(dev, dtype, D,
                                                         causal, p):
    """A head dim below the kernel's width W runs the W kernels on q, k,
    v at their own head dim, with no copy: output and gradients equal, to
    the bit, what the same kernels give on inputs zero-padded to W
    beforehand (sliced back to D), with the scale of the true D passed to
    both, the same seed, and a row whose keys are all masked."""
    B, L, H = 3, 256, 2
    width = fused_attention.kernel_head_dim(D)
    g = torch.Generator(device=dev).manual_seed(L + D)
    q, k, v, do = (torch.randn(B, L, H, D, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    mask = _mask(B, L, dev)
    kind = "causal_" if causal else ""

    def run(tensors, grad):
        leaves = [t.clone().requires_grad_() for t in tensors]
        gen = torch.Generator(device=dev).manual_seed(5)
        if causal:
            out = fused_attention.causal_attention(*leaves, mask, D ** -0.5)
        else:
            out = fused_attention.fused_dropout_attention(
                *leaves, mask, p, gen, D ** -0.5)
        out.backward(grad)
        return [out] + [t.grad for t in leaves]

    before = dict(fused_attention.PADDED_LAUNCHES)
    got = run((q, k, v), do)
    assert fused_attention.PADDED_LAUNCHES[kind + "fwd"] \
        == before[kind + "fwd"] + 1
    assert fused_attention.PADDED_LAUNCHES[kind + "bwd"] \
        == before[kind + "bwd"] + 1
    pad = [torch.nn.functional.pad(t, (0, width - D)) for t in (q, k, v, do)]
    wide = run(pad[:3], pad[3])
    torch.cuda.synchronize()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, wide):
        assert a.shape == q.shape and a.is_contiguous(), name
        assert torch.equal(a.view(bits), b[..., :D].contiguous().view(bits)), \
            name


def test_attention_dropout_mask_is_a_function_of_the_seed(dev):
    seed = torch.tensor([1234], device=dev)
    a = fused_attention.keep_mask(seed, 2, 3, 128, 0.1)
    b = fused_attention.keep_mask(seed, 2, 3, 128, 0.1)
    c = fused_attention.keep_mask(seed + 1, 2, 3, 128, 0.1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.float().mean()) - 0.9) < 0.01
    # p = 0.1 keeps a superset of p = 0.5: one threshold on the same bits
    d = fused_attention.keep_mask(seed, 2, 3, 128, 0.5)
    assert bool((a | ~d).all())


@pytest.mark.parametrize("offset", [0, 2, 4])
def test_keep_mask_with_a_head_offset_is_the_full_layers(dev, offset):
    """A tensor-parallel rank's heads offset .. + H of a layer of 6 heads
    draw exactly the masks the whole layer draws for them."""
    seed = torch.tensor([4321], device=dev)
    full = fused_attention.keep_mask(seed, 3, 6, 128, 0.1)
    part = fused_attention.keep_mask(seed, 3, 2, 128, 0.1,
                                     head_offset=offset, total_heads=6)
    assert torch.equal(part, full[:, offset:offset + 2])
    assert not torch.equal(part, full[:, :2]) or offset == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
def test_attention_with_a_head_offset_matches_plain_on_the_full_mask(
        dev, dtype, D):
    """Forward and backward on heads 3..5 of a layer of 6: the kernels draw
    the full layer's mask of those heads (held by the plain version fed
    that mask)."""
    B, L, H, total, offset, p = 3, 256, 3, 6, 3, 0.1
    g = torch.Generator(device=dev).manual_seed(D)
    q, k, v, do = (torch.randn(B, L, H, D, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    mask = _mask(B, L, dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    state = g.get_state()
    got = fused_attention.fused_dropout_attention(
        *leaves, mask, p, g, head_offset=offset, total_heads=total)
    got.backward(do)
    keep = fused_attention.keep_mask(drawn_seed(g, state), B, total, L,
                                     p)[:, offset:offset + H]
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = fused_attention.attention_reference(*ref_leaves, mask, D ** -0.5,
                                              keep, p)
    ref.backward(do)
    _close(got, ref, *ATTN_TOL[dtype])
    for a, b in zip(leaves, ref_leaves):
        _close(a.grad, b.grad, *GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", fused_layernorm.REGISTER_HIDDEN)
@pytest.mark.parametrize("R", [1, 7, 480, 5000])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_layernorm_kernel_forward_and_gradients_match_plain(dev, dtype, H, R,
                                                            p):
    g = torch.Generator(device=dev).manual_seed(R * H)
    x, y, go = (torch.randn(R, H, generator=g, device=dev).to(dtype)
                for _ in range(3))
    w = 1.0 + 0.1 * torch.randn(H, generator=g, device=dev)
    b = 0.1 * torch.randn(H, generator=g, device=dev)
    leaves = [t.clone().requires_grad_() for t in (x, y, w, b)]
    fwd, bwd = fused_layernorm.LAUNCHES, fused_layernorm.BWD_LAUNCHES
    state = g.get_state()
    got = fused_layernorm.fused_residual_layernorm(*leaves, 1e-5, p, g)
    got.backward(go)
    assert fused_layernorm.LAUNCHES == fwd + 1
    assert fused_layernorm.BWD_LAUNCHES == bwd + 1
    keep = None
    if p > 0.0:
        g.set_state(state)
        seed = torch.randint(0, 1 << 62, (1,), generator=g, device=dev,
                             dtype=torch.int64)
        keep = fused_layernorm.keep_mask(seed, R, H, p)
    ref_leaves = [t.clone().requires_grad_() for t in (x, y, w, b)]
    ref = fused_layernorm.residual_layernorm_reference(*ref_leaves, 1e-5,
                                                       keep, p)
    ref.backward(go)
    _close(got, ref, *LN_TOL[dtype])
    for a, c in zip(leaves[:2], ref_leaves[:2]):
        _close(a.grad, c.grad, *GRAD_TOL[dtype])
    # dscale, dbias: f32 sums over R rows of terms of size ~1
    for a, c in zip(leaves[2:], ref_leaves[2:]):
        _close(a.grad, c.grad, 1e-5 * R + 1e-4, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [1152, 1536, 2048, 4096,
                               fused_layernorm.MAX_HIDDEN])
@pytest.mark.parametrize("R", [1, 7, 480])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_wide_layernorm_forward_and_gradients_match_plain(dev, dtype, H, R,
                                                          p):
    """Rows past 1024 take the wide route (a block of 256 threads a row,
    WIDE_LAUNCHES), with the register route's dropout bits and column
    sums."""
    g = torch.Generator(device=dev).manual_seed(R * H)
    x, y, go = (torch.randn(R, H, generator=g, device=dev).to(dtype)
                for _ in range(3))
    w = 1.0 + 0.1 * torch.randn(H, generator=g, device=dev)
    b = 0.1 * torch.randn(H, generator=g, device=dev)
    leaves = [t.clone().requires_grad_() for t in (x, y, w, b)]
    fwd, bwd = fused_layernorm.WIDE_LAUNCHES, fused_layernorm.WIDE_BWD_LAUNCHES
    state = g.get_state()
    got = fused_layernorm.fused_residual_layernorm(*leaves, 1e-5, p, g)
    got.backward(go)
    assert fused_layernorm.WIDE_LAUNCHES == fwd + 1
    assert fused_layernorm.WIDE_BWD_LAUNCHES == bwd + 1
    keep = None
    if p > 0.0:
        keep = fused_layernorm.keep_mask(drawn_seed(g, state), R, H, p)
    ref_leaves = [t.clone().requires_grad_() for t in (x, y, w, b)]
    ref = fused_layernorm.residual_layernorm_reference(*ref_leaves, 1e-5,
                                                       keep, p)
    ref.backward(go)
    _close(got, ref, *LN_TOL[dtype])
    for a, c in zip(leaves[:2], ref_leaves[:2]):
        _close(a.grad, c.grad, *GRAD_TOL[dtype])
    for a, c in zip(leaves[2:], ref_leaves[2:]):
        _close(a.grad, c.grad, 1e-5 * R + 1e-4, 1e-4)


@pytest.mark.parametrize("H", [768, 2048])
def test_kernel_backward_is_reproducible(dev, H):
    """No float atomics: the same inputs and seed give the same bits, on
    the register route and the wide one."""
    g = torch.Generator(device=dev)
    x, y, go = (torch.randn(5000, H, device=dev) for _ in range(3))
    w, b = torch.ones(H, device=dev), torch.zeros(H, device=dev)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (x, y, w, b)]
        g.manual_seed(7)
        fused_layernorm.fused_residual_layernorm(*leaves, 1e-5, 0.1,
                                                 g).backward(go)
        grads.append([t.grad for t in leaves])
    for a, c in zip(*grads):
        assert torch.equal(a, c)


def _layernorm_against_plain(dev, R, H, dtype, p, seed):
    """One forward and backward of the kernels against autograd through
    the plain version under the kernels' own keep mask."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x, y, go = (torch.randn(R, H, generator=g, device=dev).to(dtype)
                for _ in range(3))
    w = 1.0 + 0.1 * torch.randn(H, generator=g, device=dev)
    b = 0.1 * torch.randn(H, generator=g, device=dev)
    leaves = [t.clone().requires_grad_() for t in (x, y, w, b)]
    state = g.get_state()
    got = fused_layernorm.fused_residual_layernorm(*leaves, 1e-5, p, g)
    got.backward(go)
    keep = None
    if p > 0.0:
        keep = fused_layernorm.keep_mask(drawn_seed(g, state), R, H, p)
    ref_leaves = [t.clone().requires_grad_() for t in (x, y, w, b)]
    ref = fused_layernorm.residual_layernorm_reference(*ref_leaves, 1e-5,
                                                       keep, p)
    ref.backward(go)
    _close(got, ref, *LN_TOL[dtype])
    for a, c in zip(leaves[:2], ref_leaves[:2]):
        _close(a.grad, c.grad, *GRAD_TOL[dtype])
    for a, c in zip(leaves[2:], ref_leaves[2:]):
        _close(a.grad, c.grad, 1e-5 * R + 1e-4, 1e-4)


def _rows_near_the_grid(dev, H, dtype, p, which):
    """Row counts where the backward's grid changes shape: one row, a row a
    block on either side of the SM count, and either side of the rows the
    card holds at once (the grid's cap: past it a group walks a second
    row)."""
    x = torch.empty(1, H, dtype=dtype, device=dev)
    plan = fused_layernorm._plan(x, p > 0.0)
    full = plan.rows_per_block * plan.blocks_per_sm * plan.sms
    sms = plan.rows_per_block * plan.sms
    return {"one": 1, "sms-1": sms - 1, "sms": sms, "sms+1": sms + 1,
            "full-1": full - 1, "full": full, "full+1": full + 1}[which]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [768, 1024, 2048])
@pytest.mark.parametrize("which", ["one", "sms-1", "sms", "sms+1", "full-1",
                                   "full", "full+1"])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_layernorm_row_counts_around_the_grid(dev, dtype, H, which, p):
    R = _rows_near_the_grid(dev, H, dtype, p, which)
    _layernorm_against_plain(dev, R, H, dtype, p, seed=R + H)


def test_layernorm_backwards_back_to_back_leave_the_counters_zeroed(dev):
    """Backward calls one after another on one stream, the register and the
    wide route in turn at other row counts (so other grids and splits): a
    counter left unreset by one would make blocks of the next sum the
    workspace before every block had written its row, and dscale / dbias
    would be wrong."""
    for i, (R, H) in enumerate([(5000, 768), (700, 2048), (3, 256),
                                (1, 4096), (20000, 1024), (9, 8192),
                                (4096, 768), (6000, 1536), (2, 128)]):
        dtype = torch.bfloat16 if i % 2 else torch.float32
        _layernorm_against_plain(dev, R, H, dtype, 0.1 if i % 3 else 0.0,
                                 seed=i)
    counters = fused_layernorm._counters(torch.device(dev))
    torch.cuda.synchronize()
    assert int(counters.abs().sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", range(128, fused_layernorm.MAX_HIDDEN + 1, 128))
def test_layernorm_dropout_output_matches_plain_at_every_width(dev, dtype, H):
    """p = 0.1 at every width the kernels take: the output equals the plain
    version under `keep_mask`'s mask (the 16-byte chunks of the bf16
    kernels draw two Philox words a chunk, the bits of the mask)."""
    R = 37
    g = torch.Generator(device=dev).manual_seed(H)
    x, y = (torch.randn(R, H, generator=g, device=dev).to(dtype)
            for _ in range(2))
    w = 1.0 + 0.1 * torch.randn(H, generator=g, device=dev)
    b = 0.1 * torch.randn(H, generator=g, device=dev)
    state = g.get_state()
    with torch.no_grad():
        got = fused_layernorm.fused_residual_layernorm(x, y, w, b, 1e-5, 0.1,
                                                       g)
    keep = fused_layernorm.keep_mask(drawn_seed(g, state), R, H, 0.1)
    ref = fused_layernorm.residual_layernorm_reference(x, y, w, b, 1e-5, keep,
                                                       0.1)
    _close(got, ref, *LN_TOL[dtype])


def _small_model(seed=0):
    enc = TransformerConfig(vocab_size=64, hidden_size=128,
                            num_hidden_layers=2, num_attention_heads=2,
                            intermediate_size=256,
                            max_position_embeddings=128, type_vocab_size=2,
                            attention_impl="flash", layernorm_impl="fused")
    dec = enc.replace(vocab_size=40, max_position_embeddings=16,
                      type_vocab_size=1, is_decoder=True,
                      add_cross_attention=True, bos_token_id=1,
                      eos_token_id=2)
    model = EncoderDecoder(enc, dec, dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval()


def _batch(B=3, L=128):
    rng = np.random.default_rng(0)
    mask = np.zeros((B, L), np.int32)
    mask[0] = 1
    mask[1, :70] = 1
    return {"input_ids": rng.integers(1, 64, (B, L)).astype(np.int32),
            "attention_mask": mask}


def test_model_on_card_matches_cpu(dev):
    """The same f32 weights and batch: encoder states through the kernels
    on the card against the plain path on the CPU, and identical beams."""
    cpu_model = _small_model()
    gpu_model = _small_model().to(dev)
    batch = _batch()
    ids = torch.as_tensor(batch["input_ids"], dtype=torch.long)
    mask = torch.as_tensor(batch["attention_mask"])
    attn, ln = fused_attention.LAUNCHES, fused_layernorm.LAUNCHES
    with torch.inference_mode():
        ref = cpu_model.encode(ids, mask)
        got = gpu_model.encode(ids.to(dev), mask.to(dev)).cpu()
    assert fused_attention.LAUNCHES == attn + 2
    assert fused_layernorm.LAUNCHES == ln + 4
    # f32, 2 layers; card and CPU sum in different orders
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    cpu_seqs, cpu_scores = Generator(cpu_model, 3, 8).generate(batch)
    seqs, scores = Generator(gpu_model, 3, 8).generate(batch)
    np.testing.assert_array_equal(seqs, cpu_seqs)
    np.testing.assert_allclose(scores, cpu_scores, rtol=1e-4)


# the retro serving geometry: 32 examples, 12 heads of 64, beam 20 over 160
# decoder positions, encoder length 512
RETRO_DECODE = dict(B=32, H=12, D=64, G=20, T=160, L=512)


def _product_bound(a, b, out_dtype):
    """|card - CPU route| allowed for one decode product: both sum bf16
    products exactly in f32, in other orders, which moves a sum by at most
    2^-16 of the sum of |terms| at these depths (<= 3200 terms); a result
    rounded to bf16 may then round the other way, one bf16 ulp, 2^-7 of
    it."""
    sum_abs = torch.bmm(a.float().abs(), b.float().abs())
    return 2.0 ** -16 * sum_abs, (2.0 ** -7 if out_dtype == torch.bfloat16
                                  else 0.0)


@pytest.mark.parametrize("W", [48, 80, 160])
def test_decode_products_match_the_cpu_route(dev, W):
    """The decode attention's products on the card (bf16 operands read in
    place; cuBLAS bmm into bf16, its out_dtype overload into f32) against
    the CPU route's _matmul_f32 (f32 up-casts, f32 product) on the same
    tensors: the grouped self-attention over a window W of the (B, H, D,
    T*G) cache, scores into bf16 and f32 and the context, and the cross
    attention over (B, H, L, D), scores into f32 and the context."""
    from textreact_tpu_torch.ops.decode_attention import (_decode_bmm,
                                                          _matmul_f32)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    c = RETRO_DECODE
    B, H, D, G, T, L = (c[k] for k in "BHDGTL")
    g = torch.Generator(device=dev).manual_seed(W)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    cache = randn(B, H, D, T * G)
    k = cache[..., :W * G].view(B * H, D, W * G)
    q = randn(B * H, G, D)
    probs = torch.softmax(randn(B * H, G, W * G).float(), -1).to(
        torch.bfloat16)
    cross_k, cross_v = randn(B * H, L, D), randn(B * H, L, D)
    cross_p = torch.softmax(randn(B * H, G, L).float(), -1).to(
        torch.bfloat16)
    cases = [(q, k, torch.bfloat16), (q, k, torch.float32),
             (probs, k.transpose(1, 2), torch.bfloat16),
             (q, cross_k.transpose(1, 2), torch.float32),
             (cross_p, cross_v, torch.bfloat16)]
    for a, b, out_dtype in cases:
        got = _decode_bmm(a, b, out_dtype)
        ref = _matmul_f32(a, b).to(out_dtype)
        assert got.dtype == out_dtype and got.shape == ref.shape
        atol, rtol = _product_bound(a, b, out_dtype)
        diff = (got.float() - ref.float()).abs()
        assert (diff <= atol + rtol * ref.float().abs()).all(), \
            (out_dtype, float(diff.max()))


def test_grouped_decode_step_writes_its_cache_in_place(dev):
    """A grouped decode step at the retro geometry (640 rows, a 160-slot
    cache of 20 beams, bf16; two decoder layers) writes each position's
    K/V into the cache where it lies: every layer's storage keeps its
    address, the step's slots fill and the later ones stay zero."""
    from textreact_tpu_torch.inference.beam import ancestor_bias
    from textreact_tpu_torch.models import DecoderStep
    c = RETRO_DECODE
    B, G, T, L = c["B"], c["G"], c["T"], c["L"]
    enc = TransformerConfig(num_hidden_layers=1, vocab_size=64,
                            max_position_embeddings=L,
                            layernorm_impl="fused")
    dec = enc.replace(num_hidden_layers=2, vocab_size=600,
                      max_position_embeddings=T, is_decoder=True,
                      add_cross_attention=True)
    model = EncoderDecoder(enc, dec, dtype=torch.bfloat16,
                           param_dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    step = DecoderStep(model.decoder, beam_groups=G)
    rng = np.random.default_rng(0)
    states = torch.randn(B, L, enc.hidden_size, device=dev,
                         dtype=torch.bfloat16)
    mask = _mask(B, L, dev)
    mask[-1, 0] = 1
    src = torch.zeros(B, G, T, dtype=torch.long, device=dev)
    W = 48
    with torch.inference_mode():
        cache = step.init_cache(states, mask, G, T)
        assert cache.self_k[0].shape == (B, 12, 64, T * G)
        tensors = cache.self_k + cache.self_v
        where = [t.data_ptr() for t in tensors]
        for pos in range(3):
            src[:, :, pos] = torch.arange(G, device=dev)
            tokens = torch.as_tensor(rng.integers(3, 600, (B * G, 1)),
                                     device=dev)
            logits = step(tokens, cache, pos,
                          ancestor_bias(src[:, :, :W], pos + 1, B, G, W))
            torch.cuda.synchronize()
            assert logits.shape == (B * G, 1, 600)
            assert torch.isfinite(logits).all()
            assert [t.data_ptr() for t in cache.self_k + cache.self_v] == where
            for t in tensors:
                assert (t[..., pos * G:(pos + 1) * G] != 0).any()
                assert not t[..., (pos + 1) * G:].any()
            parents = torch.as_tensor(rng.integers(0, G, (B, G)), device=dev)
            src = torch.gather(src, 1, parents[:, :, None].expand(-1, -1, T))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden,heads", [(256, 2), (640, 10)],
                         ids=["h2d128", "hidden640"])
def test_wide_heads_and_hidden_sizes_run_their_kernels(dev, hidden, heads,
                                                       dtype):
    """Heads of 128 and a hidden size of 640 on the card: attention and
    LayerNorm launch their kernels (2 layers: 2 and 4 launches), and the
    encoder states equal those of the plain functions on the same card
    (f32: summation order; bf16: the kernels' own rounding points)."""
    from chip_smoke import set_kernels
    enc = TransformerConfig(vocab_size=64, hidden_size=hidden,
                            num_hidden_layers=2, num_attention_heads=heads,
                            intermediate_size=2 * hidden,
                            max_position_embeddings=128, type_vocab_size=2,
                            attention_impl="flash", layernorm_impl="fused")
    dec = enc.replace(vocab_size=40, max_position_embeddings=16,
                      type_vocab_size=1, is_decoder=True,
                      add_cross_attention=True, bos_token_id=1,
                      eos_token_id=2)
    model = EncoderDecoder(enc, dec, dtype=dtype)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.eval().to(dev)
    batch = _batch()
    ids = torch.as_tensor(batch["input_ids"], dtype=torch.long, device=dev)
    mask = torch.as_tensor(batch["attention_mask"], device=dev)
    attn, ln = fused_attention.LAUNCHES, fused_layernorm.LAUNCHES
    with torch.inference_mode():
        got = model.encode(ids, mask)
        torch.cuda.synchronize()
        launched = (fused_attention.LAUNCHES - attn,
                    fused_layernorm.LAUNCHES - ln)
        set_kernels(model, False)
        ref = model.encode(ids, mask)
    assert launched == (2, 4), launched
    assert torch.isfinite(got).all()
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


def _fps(rng, n, d, kind):
    if kind == "binary":
        return (rng.random((n, d)) < 0.08).astype(np.int8)
    if kind == "counts":  # sparse signed counts, as reaction fingerprints
        return (rng.integers(-3, 4, (n, d))
                * (rng.random((n, d)) < 0.05)).astype(np.int8)
    return rng.integers(-127, 128, (n, d)).astype(np.int8)


def _topk_both_layouts(queries, corpus, n_real, banned, k, dev):
    """Both layouts on the card, each held to the plain version on the card
    and (where the corpus fills k) to the numpy oracle: equal, tolerance 0."""
    norms = topk.corpus_norms_padded(corpus, n_real)
    args = [torch.from_numpy(a).to(dev) for a in (queries, corpus, norms)]
    b = None if banned is None else torch.from_numpy(banned).to(dev)
    ref_v, ref_i = topk.exact_topk_l2_reference(*args, b, k=k)
    counts = (topk.LARGE_K_LAUNCHES if k > topk.INSERT_K
              else topk.LAUNCHES)
    for resident, name in ((False, "query_outer"), (True, "corpus_split")):
        before = counts[name]
        vals, idx = topk.exact_topk_l2(*args, b, k=k,
                                       corpus_resident=resident)
        torch.cuda.synchronize()
        assert counts[name] == before + 1
        assert torch.equal(idx, ref_i), name
        assert torch.equal(vals, ref_v), name
    if n_real >= k + (0 if banned is None else banned.shape[1]):
        o_v, o_i = topk.numpy_reference_topk(queries, corpus[:n_real], k,
                                             banned)
        np.testing.assert_array_equal(ref_i.cpu().numpy(), o_i)
        np.testing.assert_array_equal(ref_v.cpu().numpy(), o_v)
    return ref_v, ref_i


@pytest.mark.parametrize("k", [1, 5, 20, 100, 128, 129, 192, 256, 257, 512,
                               1024])
@pytest.mark.parametrize("M,N,d,kind", [
    (37, 601, 128, "binary"), (130, 1000, 1024, "binary"),
    (257, 3001, 2048, "counts"), (5, 129, 256, "full"),
    (128, 128, 2048, "full"), (1, 50, 16, "counts"), (40, 700, 200, "full")])
def test_topk_kernels_equal_plain_version(dev, M, N, d, kind, k):
    rng = np.random.default_rng(M + N + k)
    corpus = _fps(rng, N, d, kind)
    # duplicate rows, so that equal distances cross tile and slab boundaries
    src = rng.integers(0, N, N // 3)
    corpus[rng.integers(0, N, N // 3)] = corpus[src]
    queries = _fps(rng, M, d, kind)
    queries[: M // 2] = corpus[rng.integers(0, N, M // 2)]
    _topk_both_layouts(queries, corpus, N, None, k, dev)


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("k", [5, 20, 129, 256, 512])
def test_topk_kernels_banned_ids_and_padding_rows(dev, nb, k):
    """Banned ids, padding rows and ties: four groups of 60 equal rows
    spread over the corpus, and queries equal to them, so that a tie runs
    through the k-th place and across the large-k route's runs, on both
    sides of its plan's boundary between lists in shared memory (k = 129,
    256) and in device memory (k = 512)."""
    rng = np.random.default_rng(nb + k)
    corpus = topk.pad_matrix(_fps(rng, 900, 256, "binary"), 128, 16)
    corpus[rng.integers(0, 900, 300)] = corpus[rng.integers(0, 900, 300)]
    for j in range(4):
        corpus[rng.choice(900, 60, replace=False)] = corpus[j]
    queries = corpus[:200].copy()
    banned = rng.integers(-1, 900, (200, nb)).astype(np.int32)
    banned[:, 0] = np.arange(200)  # masked self-retrieval
    _, idx = _topk_both_layouts(queries, corpus, 900, banned, k, dev)
    idx = idx.cpu().numpy()
    assert (idx < 900).all()  # no padding row entered
    for b in range(nb):
        assert not (idx == banned[:, b:b + 1]).any()


@pytest.mark.parametrize("N", [1, 5, 19])
def test_topk_kernels_corpus_smaller_than_k(dev, N):
    rng = np.random.default_rng(N)
    corpus, queries = _fps(rng, N, 128, "binary"), _fps(rng, 9, 128, "binary")
    vals, idx = _topk_both_layouts(queries, corpus, N, None, 20, dev)
    qn = torch.from_numpy((queries.astype(np.int64) ** 2).sum(1)).to(dev)
    assert (idx[:, N:] == topk.BIG).all() and (idx[:, :N] < N).all()
    assert torch.equal(vals[:, N:].long(),
                       (topk.BIG + qn)[:, None].expand(-1, 20 - N))


@pytest.mark.parametrize("M,N,d,k,nb,kind", [
    (65, 129, 16, 1, 0, "counts"), (63, 255, 2048, 128, 3, "full"),
    (200, 1000, 48, 128, 2, "binary"), (129, 3000, 2048, 20, 1, "counts"),
    (64, 128, 16, 128, 0, "full"), (1, 700, 1024, 20, 3, "binary"),
    (70, 700, 128, 20, 0, "equal"), (70, 700, 128, 128, 2, "equal")])
def test_topk_scan_at_the_edges_of_its_tiles(dev, M, N, d, k, nb, kind):
    """The wgmma scan at the edges of its tiles and of its ring: a corpus
    that ends inside a tile, queries that end inside a warpgroup's 64, d of
    one 16-byte piece and of sixteen 128-byte stages, k = 1 and k = 128
    (three stages beside the lists), 0-3 banned ids a query, and a corpus of
    equal rows, where every distance ties and the order is the index's."""
    rng = np.random.default_rng(M + N + d + k + nb)
    if kind == "equal":
        corpus = np.repeat(_fps(rng, 1, d, "counts"), N, axis=0)
    else:
        corpus = _fps(rng, N, d, kind)
        corpus[rng.integers(0, N, N // 3)] = corpus[rng.integers(0, N, N // 3)]
    queries = _fps(rng, M, d, "counts" if kind == "equal" else kind)
    queries[: M // 2] = corpus[rng.integers(0, N, M // 2)]
    banned = None
    if nb:
        banned = rng.integers(-1, N, (M, nb)).astype(np.int32)
    _, idx = _topk_both_layouts(queries, corpus, N, banned, k, dev)
    if kind == "equal" and banned is None:
        assert (idx.cpu().numpy() == np.arange(k)).all()


@pytest.mark.parametrize("case", ["many_query_tiles", "many_slabs"])
def test_topk_scan_walks_several_items_a_block(dev, monkeypatch, case):
    """More work items than three times the card's SMs, so every persistent
    block walks several: its lists and k-th scores start afresh at each item
    and its ring's phase runs on from one item into the next. Many query
    tiles (both layouts, 4-5 items a block), and many slabs of two tiles
    with four items an SM (corpus split; half the slabs lie past the
    corpus's end and yield empty lists). Both layouts equal the plain
    version, tolerance 0."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(len(case))
    if case == "many_query_tiles":
        M, N, d, nb, kind = 4 * sms * topk.TILE_Q + 5, 300, 16, 2, "full"
    else:
        monkeypatch.setattr(topk, "ITEMS_PER_SM", 4)
        M, N, d, nb, kind = 300, 200 * topk.TILE_C + 7, 32, 1, "binary"
    corpus = _fps(rng, N, d, kind)
    corpus[rng.integers(0, N, N // 3)] = corpus[rng.integers(0, N, N // 3)]
    queries = _fps(rng, M, d, kind)
    queries[: M // 2] = corpus[rng.integers(0, N, M // 2)]
    banned = rng.integers(-1, N, (M, nb)).astype(np.int32)
    items = -(-M // topk.TILE_Q) * topk.split_slabs(M, N, dev)
    assert items > 3 * sms, items
    _topk_both_layouts(queries, corpus, N, banned, 20, dev)


def test_ring_fits_beside_the_lists(dev):
    """Every k the kernels take leaves the scan a ring of 2-4 stages and
    stays inside the 227 KB a block may use; k = 20 keeps all four stages,
    k = 128 three beside its lists; past INSERT_K a work item is 64
    queries, whose lists stay in shared memory at k = 256 (three stages)
    and leave it by k = 512 (four again). The numbers are the library's own
    (tr_topk_scan_plan)."""
    for k in range(1, topk.MAX_K + 1):
        plan = topk.scan_shared(k)
        assert 2 <= plan.stages <= 4 and plan.shared_bytes <= 227 * 1024
    assert topk.scan_shared(20).stages == 4
    assert topk.scan_shared(128).stages == 3
    assert topk.scan_shared(256) == (64, 3, 214080, False)
    assert topk.scan_shared(512).device_lists
    assert topk.scan_shared(512).stages == 4
    with pytest.raises(ValueError, match=f"1..{topk.MAX_K}"):
        topk.scan_shared(topk.MAX_K + 1)


def test_library_plan_equals_python_plan(dev):
    """The library's plan (tr_topk_scan_plan: queries a work item, stages,
    shared bytes, where the lists are) is topk.scan_layout's, which the
    wrapper sizes the lists' workspace by, for every k in 1..MAX_K."""
    for k in range(1, topk.MAX_K + 1):
        assert topk.scan_shared(k) == topk.scan_layout(k), k


def test_topk_kernel_raises_on_what_it_does_not_take(dev):
    q = torch.zeros((4, 128), dtype=torch.int8, device=dev)
    c = torch.zeros((50, 128), dtype=torch.int8, device=dev)
    n = torch.zeros(50, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        topk.exact_topk_l2(q, c, n, k=topk.MAX_K + 1)
    with pytest.raises(TypeError):
        topk.exact_topk_l2(q.int(), c, n)
    with pytest.raises(ValueError):
        topk.exact_topk_l2(q, c.cpu(), n)
    with pytest.raises(ValueError):
        topk.exact_topk_l2(q, c[:, :64], n)
    with pytest.raises(ValueError):
        topk.exact_topk_l2(q, c, n[:49])


def test_flat_index_on_card_chunks_and_layouts(dev, monkeypatch):
    """FlatIndex on the card (odd width, default layout and both explicit
    ones, a query set cut into chunks) against the numpy oracle."""
    from textreact_tpu_torch.retrieval import engine
    rng = np.random.default_rng(0)
    corpus, queries = _fps(rng, 2000, 1000, "counts"), _fps(rng, 700, 1000,
                                                            "counts")
    ref = topk.numpy_reference_topk(queries, corpus, 20)
    monkeypatch.setattr(engine, "SEARCH_BUDGET_BYTES", 256 * 2000)
    for resident in (None, False, True):
        index = FlatIndex(corpus, corpus_resident=resident)
        assert index.device.type == "cuda" and index.max_queries(20, 1) < 700
        got = index.search(queries, k=20)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("banned", [False, True])
def test_sharded_flat_index_on_card_chunks(dev, monkeypatch, banned):
    """FlatIndex over two shards on the card (two cards where there are
    two, else the one card twice), its queries cut into chunks that each
    go to both shards before either is read, against the numpy oracle."""
    from textreact_tpu_torch.retrieval import engine
    rng = np.random.default_rng(1)
    corpus, queries = _fps(rng, 2001, 1000, "counts"), _fps(rng, 700, 1000,
                                                            "counts")
    ban = (rng.integers(-1, 2001, (700, 3)).astype(np.int32) if banned
           else None)
    ref = topk.numpy_reference_topk(queries, corpus, 20, ban)
    monkeypatch.setattr(engine, "SEARCH_BUDGET_BYTES", 256 * 2000)
    devices = [f"cuda:{min(s, torch.cuda.device_count() - 1)}"
               for s in range(2)]
    index = FlatIndex(corpus, devices=devices)
    assert index.shards[0][1].max_queries(20, 3) < 700
    got = index.search(queries, k=20, banned=ban)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


# ---- causal attention (csrc/causal_attention.cu, causal_attention_bwd.cu) --


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,H,D", [(128, 2, 64), (256, 4, 32), (512, 3, 64),
                                   (384, 2, 32), (256, 2, 128)])
@pytest.mark.parametrize("masked", [True, False])
def test_causal_attention_kernel_forward_and_gradients_match_plain(
        dev, dtype, L, H, D, masked):
    """Ragged right-padded mask with an all-masked dummy row; forward and
    dq, dk, dv against autograd through the plain version, and the launch
    counters of the causal kernels alone."""
    B = 3
    g = torch.Generator(device=dev).manual_seed(L + D)
    q, k, v, do = (torch.randn(B, L, H, D, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    mask = _mask(B, L, dev) if masked else None
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    counts = (fused_attention.CAUSAL_LAUNCHES,
              fused_attention.CAUSAL_BWD_LAUNCHES,
              fused_attention.LAUNCHES, fused_attention.BWD_LAUNCHES)
    out = fused_attention.causal_attention(*leaves, mask)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fused_attention.CAUSAL_LAUNCHES,
            fused_attention.CAUSAL_BWD_LAUNCHES, fused_attention.LAUNCHES,
            fused_attention.BWD_LAUNCHES) == (counts[0] + 1, counts[1] + 1,
                                              counts[2], counts[3])
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = fused_attention.attention_reference(*ref_leaves, mask, D ** -0.5,
                                              causal=True)
    ref.backward(do)
    assert out.dtype == dtype and torch.isfinite(out).all()
    _close(out, ref, *ATTN_TOL[dtype])
    for a, b in zip(leaves, ref_leaves):
        assert torch.isfinite(a.grad).all()
        _close(a.grad, b.grad, *GRAD_TOL[dtype])


def test_causal_attention_kernel_sees_no_key_above_the_diagonal(dev):
    """Changing k and v at positions above a row leaves the row unchanged,
    to the bit: the tiles above the diagonal are not read, and inside the
    diagonal tiles the weight is exactly 0."""
    B, L, H, D = 2, 256, 2, 64
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(B, L, H, D, generator=g, device=dev)
               for _ in range(3))
    out = fused_attention.causal_attention(q, k, v, None)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:] = 7.0
    v2[:, 100:] = -3.0
    out2 = fused_attention.causal_attention(q, k2, v2, None)
    torch.cuda.synchronize()
    assert torch.equal(out[:, :100], out2[:, :100])
    assert not torch.equal(out[:, 100:], out2[:, 100:])


def test_causal_attention_kernel_raises_on_what_it_does_not_take(dev):
    with pytest.raises(ValueError):   # retro's decoder length: not aligned
        x = torch.randn(2, 160, 2, 64, device=dev)
        fused_attention.causal_attention(x, x, x, None)
    for D in (100, 136):   # head dims: multiples of 8 up to 128
        with pytest.raises(ValueError):
            x = torch.randn(2, 128, 1, D, device=dev)
            fused_attention.causal_attention(x, x, x, None)
    with pytest.raises(TypeError):
        x = torch.randn(2, 128, 2, 64, device=dev).half()
        fused_attention.causal_attention(x, x, x, None)


# ---- the bf16 tensor-core attention kernels (csrc/attention_mma.cuh) -------
# bfloat16 reaches the `mma.sync` kernels and float32 the exact ones, by the
# element type alone; the cases above already run both. These add what the
# tensor-core design can get wrong: every head dim at every tile count,
# masks that are no prefix (whole tiles masked, a row with no valid key
# beside rows with some), the three kernels' dropout bits, and tile skipping.


def _holes_mask(B, L, dev, seed=0):
    """The smoke run's mask that is no prefix, on the card."""
    mask = ragged_holes_mask(B, L, np.random.default_rng(seed))
    return torch.as_tensor(mask, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("L", [128, 256, 512, 1024])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_tensor_core_attention_under_a_mask_with_holes(dev, D, L, p):
    B, H, dtype = 4, 3, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(L + D)
    q, k, v, do = (torch.randn(B, L, H, D, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    mask = _holes_mask(B, L, dev, seed=L)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    state = g.get_state()
    got = fused_attention.fused_dropout_attention(*leaves, mask, p, g)
    got.backward(do)
    keep = None
    if p > 0.0:
        keep = fused_attention.keep_mask(drawn_seed(g, state), B, H, L,
                                         p)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = fused_attention.attention_reference(*ref_leaves, mask, D ** -0.5,
                                              keep, p)
    ref.backward(do)
    assert torch.isfinite(got).all()
    _close(got, ref, *ATTN_TOL[dtype])
    if p == 0.0:  # the row with no valid key averages v
        _close(got[-1], v[-1].float().mean(0, keepdim=True).expand(L, H, D),
               *ATTN_TOL[dtype])
    for a, b in zip(leaves, ref_leaves):
        assert torch.isfinite(a.grad).all()
        _close(a.grad, b.grad, *GRAD_TOL[dtype])


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("L", [128, 256, 512, 1024])
def test_tensor_core_causal_attention_under_a_mask_with_holes(dev, D, L):
    """Key 0 is masked in every row here, so rows below the first valid key
    see masked keys only and are uniform over what they see."""
    B, H, dtype = 4, 3, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(L + D)
    q, k, v, do = (torch.randn(B, L, H, D, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    for mask in (_holes_mask(B, L, dev, seed=L), _mask(B, L, dev, seed=L)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = fused_attention.causal_attention(*leaves, mask)
        got.backward(do)
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = fused_attention.attention_reference(*ref_leaves, mask,
                                                  D ** -0.5, causal=True)
        ref.backward(do)
        assert torch.isfinite(got).all()
        _close(got, ref, *ATTN_TOL[dtype])
        for a, b in zip(leaves, ref_leaves):
            assert torch.isfinite(a.grad).all()
            _close(a.grad, b.grad, *GRAD_TOL[dtype])


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_tensor_core_attention_matches_its_rounding_statement(dev, D, causal):
    """Against the plain statement of the kernels' own rounding points (dS
    and the dropped probabilities rounded to bf16), the gradients agree to
    one bf16 ulp of the value plus the rounding of single terms."""
    B, L, H, dtype, p = 2, 256, 2, torch.bfloat16, 0.0 if causal else 0.1
    g = torch.Generator(device=dev).manual_seed(D)
    q, k, v, do = (torch.randn(B, L, H, D, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    mask = _mask(B, L, dev, seed=3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    state = g.get_state()
    if causal:
        got = fused_attention.causal_attention(*leaves, mask)
    else:
        got = fused_attention.fused_dropout_attention(*leaves, mask, p, g)
    got.backward(do)
    keep = None
    if p > 0.0:
        keep = fused_attention.keep_mask(drawn_seed(g, state), B, H, L,
                                         p)
    want = fused_attention.attention_rounding_reference(
        q, k, v, do, mask, D ** -0.5, keep, p, causal=causal)
    _close(got, want[0], 2e-3, 2.0 ** -7)
    for leaf, ref in zip(leaves, want[1:]):
        _close(leaf.grad, ref, 4e-3, 2.0 ** -7)


@pytest.mark.parametrize("which", ["out", "dv", "dq"])
def test_attention_kernels_draw_the_bits_keep_mask_exports(dev, which):
    """The forward (out), the dK/dV pass (dv, from the bits the dQ pass left
    it) and the dQ pass (dq) each give their dropout bits away on the probe
    inputs; out and dv are small
    integers and equal the statement to the bit, dq to one bf16 ulp. One
    flipped bit of the exported mask breaks the agreement: the check sees
    single bits."""
    B, H, L, D, p = 2, 2, 128, 64, 0.5
    q, k, v = attention_probe_inputs(dev, B, H, L, D)
    do = torch.ones_like(v) if which == "dq" else v
    g = torch.Generator(device=dev).manual_seed(11)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    state = g.get_state()
    out = fused_attention.fused_dropout_attention(*leaves, None, p, g, 1.0)
    out.backward(do)
    got = {"out": out, "dq": leaves[0].grad, "dv": leaves[2].grad}[which]
    index = {"out": 0, "dq": 1, "dv": 3}[which]
    keep = fused_attention.keep_mask(drawn_seed(g, state), B, H, L, p)
    flipped = keep.clone()
    flipped[1, 1, 70, 5] = ~flipped[1, 1, 70, 5]

    def agrees(mask):
        ref = fused_attention.attention_rounding_reference(
            q, k, v, do, None, 1.0, mask, p)[index]
        if which == "dq":
            diff = (got.float() - ref.float()).abs()
            return bool((diff <= 1e-3 + 2.0 ** -7 * ref.float().abs()).all())
        return torch.equal(got, ref)

    assert agrees(keep)
    assert not agrees(flipped)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_tensor_core_attention_repeats_to_the_bit(dev, causal, D):
    """No float atomics in either pass: one seed, the same bits, forward and
    gradients."""
    B, L, H = 3, 512, 4
    g = torch.Generator(device=dev).manual_seed(D)
    q, k, v, do = (torch.randn(B, L, H, D, generator=g,
                               device=dev).bfloat16() for _ in range(4))
    mask = _holes_mask(B, L, dev)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        g.manual_seed(7)
        if causal:
            out = fused_attention.causal_attention(*leaves, mask)
        else:
            out = fused_attention.fused_dropout_attention(*leaves, mask, 0.1,
                                                          g)
        out.backward(do)
        runs.append([out.detach(), *(t.grad for t in leaves)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_skipping_masked_key_tiles_changes_no_bit(dev, p):
    """A row of more than 64 key tiles is never scanned for masked tiles, so
    at L = 4224 every tile is visited, and at L = 4096 the masked ones are
    left out. With the keys from 4096 on masked and dO zero from row 4096 on,
    the two calls state one problem on the first 4096 rows: out, dq, dk and
    dv there are equal to the bit."""
    H, D, n, extra = 1, 32, 4096, 128
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v, do = (torch.randn(1, n + extra, H, D, generator=g,
                               device=dev).bfloat16() for _ in range(4))
    do[:, n:] = 0
    rng = np.random.default_rng(5)
    mask = rng.random((1, n + extra)) < 0.7
    for tile in (0, 3, 17, 40, 41, 63):   # key tiles masked whole
        mask[0, 64 * tile:64 * (tile + 1)] = False
    mask[0, n:] = False
    mask = torch.as_tensor(mask, dtype=torch.int32, device=dev)
    runs = []
    for length in (n + extra, n):
        leaves = [t[:, :length].clone().requires_grad_() for t in (q, k, v)]
        g.manual_seed(3)
        out = fused_attention.fused_dropout_attention(
            *leaves, mask[:, :length].contiguous(), p, g)
        out.backward(do[:, :length].contiguous())
        runs.append([out.detach()[:, :n], *(t.grad[:, :n] for t in leaves)])
    for a, b in zip(*runs):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    # the masked keys get no gradient at all
    assert not runs[1][2][0, :64].any() and not runs[1][3][0, 64 * 17].any()


def test_tensor_core_attention_raises_on_what_it_does_not_take(dev):
    x = torch.randn(2, 128, 2, 64, device=dev).bfloat16()
    for call in (fused_attention.fused_dropout_attention,
                 fused_attention.causal_attention):
        with pytest.raises(ValueError):   # a whole tile of 64, but not 128
            y = torch.randn(2, 192, 2, 64, device=dev).bfloat16()
            call(y, y, y, None)
        with pytest.raises(ValueError):   # head dim
            y = torch.randn(2, 128, 2, 20, device=dev).bfloat16()
            call(y, y, y, None)
        with pytest.raises(ValueError):   # one float32 operand
            call(x, x.float(), x, None)
        with pytest.raises(ValueError):   # not contiguous
            y = torch.randn(2, 2, 128, 64, device=dev).bfloat16()
            call(y.transpose(1, 2), y.transpose(1, 2), y.transpose(1, 2),
                 None)
        with pytest.raises(ValueError):   # mask of another shape
            call(x, x, x, torch.ones(2, 64, dtype=torch.int32, device=dev))
        with pytest.raises(ValueError):   # not 16-byte aligned
            y = torch.randn(2 * 128 * 2 * 64 + 4, device=dev).bfloat16()
            y = y[4:].view(2, 128, 2, 64)
            call(y, y, y, None)


@pytest.mark.parametrize("bond_mask", [True, False],
                         ids=["bond_mask", "key_mask"])
def test_template_model_with_kernels_matches_plain(dev, bond_mask):
    """The template model (2 layers, hidden 128, L = 128) in f32 at p = 0:
    loss and every gradient through the kernels against the plain
    functions. Under the bond mask the self-attention carries a bias and
    launches no attention kernel; the residual LNs launch theirs."""
    from chip_smoke import set_kernels
    from textreact_tpu_torch.config import ExperimentConfig
    from textreact_tpu_torch.data import Collator, RetrosynthesisDataset
    from textreact_tpu_torch.models import TemplateBasedModel
    from textreact_tpu_torch.train import make_loss_fn
    from textreact_tpu_torch.train.step import to_device

    L, n_a, n_b = 128, 37, 11
    config = TransformerConfig(
        vocab_size=64, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=256,
        max_position_embeddings=L, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    module = TemplateBasedModel(config, n_a, n_b, dtype=torch.float32)
    init_weights(module, torch.Generator().manual_seed(0))
    module.to(dev).train()
    cfg = ExperimentConfig(task="retro", template_based=True,
                           template_path="x", compute_dtype="float32",
                           max_length=L)
    rng = np.random.default_rng(0)
    examples = []
    for i, (length, atoms) in enumerate([(128, 20), (70, 9), (100, 14)]):
        bonds = sorted({p for a in range(atoms - 1)
                        for p in ((a, a + 1), (a + 1, a))})
        ex = {"id": str(i), "index": i,
              "input_ids": [int(t) for t in rng.integers(5, 64, length)],
              "attention_mask": [1] * length,
              "atom_indices": list(range(1, atoms + 1)), "bonds": bonds,
              "decoder_atom_template_locs": [1],
              "decoder_atom_template_ids": [int(rng.integers(1, n_a))],
              "decoder_bond_template_locs": [bonds[0]],
              "decoder_bond_template_ids": [int(rng.integers(1, n_b))],
              "decoder_raw_template_labels": []}
        if bond_mask:
            ex["attention_mask"] = RetrosynthesisDataset._bond_mask(ex)
        examples.append(ex)
    batch = to_device(Collator(cfg, 0, 0)(examples, fixed_batch=4,
                                          fixed_enc_len=L), dev)
    runs = []
    for on in (True, False):
        set_kernels(module, on)
        module.zero_grad(set_to_none=True)
        before = (fused_attention.LAUNCHES, fused_layernorm.LAUNCHES,
                  fused_layernorm.BWD_LAUNCHES)
        loss, _ = make_loss_fn(module, cfg, 0)(
            batch, torch.Generator(device=dev).manual_seed(0))
        loss.backward()
        torch.cuda.synchronize()
        launched = (fused_attention.LAUNCHES - before[0],
                    fused_layernorm.LAUNCHES - before[1],
                    fused_layernorm.BWD_LAUNCHES - before[2])
        want = ((0 if bond_mask else 2, 4, 4) if on else (0, 0, 0))
        assert launched == want, (on, launched)
        runs.append((float(loss), {n: p.grad.clone()
                                   for n, p in module.named_parameters()}))
    (loss_k, grads_k), (loss_p, grads_p) = runs
    assert abs(loss_k - loss_p) <= 1e-5
    top = max(float(g.abs().max()) for g in grads_p.values())
    for name, g in grads_p.items():
        diff = float((grads_k[name] - g).abs().max())
        assert diff <= 1e-3 * max(float(g.abs().max()), 1e-4 * top), name


def test_pretrained_import_onto_the_card_is_bit_exact(dev, tmp_path):
    """A SciBERT-shaped HF directory (model.safetensors, f32) and a 6-layer
    BERT decoder with the MaskedLM head (pytorch_model.bin, `bert.`) copied
    onto the card's parameters: each imported element equal to the file's
    to the bit, the rest equal to the seeded initialisation, nothing unread
    but the poolers."""
    from chip_smoke import (DECODER_HF_CONFIG, SCIBERT_HF_CONFIG,
                            check_pretrained_import, hf_bert_tensors,
                            write_hf_checkpoint)
    from textreact_tpu_torch.models.config import resolve_config
    from textreact_tpu_torch.models.import_hf import (load_pretrained_decoder,
                                                      load_pretrained_encoder)
    files = {"encoder": hf_bert_tensors(SCIBERT_HF_CONFIG, seed=1),
             "decoder": hf_bert_tensors(DECODER_HF_CONFIG, seed=2,
                                        prefix="bert.", mlm_head=True)}
    write_hf_checkpoint(tmp_path / "enc", SCIBERT_HF_CONFIG, files["encoder"],
                        "safetensors")
    write_hf_checkpoint(tmp_path / "dec", DECODER_HF_CONFIG, files["decoder"],
                        "bin")
    enc_cfg = resolve_config(str(tmp_path / "enc"))
    dec_cfg = resolve_config(str(tmp_path / "dec")).replace(
        vocab_size=314, is_decoder=True, add_cross_attention=True)
    seeded = EncoderDecoder(enc_cfg, dec_cfg, torch.bfloat16)
    init_weights(seeded, torch.Generator().manual_seed(0))
    module = EncoderDecoder(enc_cfg, dec_cfg, torch.bfloat16)
    module.load_state_dict(seeded.state_dict())
    module.to(dev)
    read = {"encoder": load_pretrained_encoder(module.encoder,
                                               str(tmp_path / "enc"), enc_cfg),
            "decoder": load_pretrained_decoder(module.decoder,
                                               str(tmp_path / "dec"), dec_cfg)}
    params = {k: v.detach().cpu() for k, v in module.named_parameters()}
    imported, kept = check_pretrained_import(
        params, dict(seeded.named_parameters()), files, read)
    assert imported > 100e6 and kept > 0
