"""The bf16 rounding points of the port's tensor-core attention kernels,
stated in plain PyTorch (`attention_rounding_reference`), against the JAX
package's Pallas kernels in interpret mode with bf16 inputs, on the CPU.

The CUDA kernels cannot run here. What can be held here is their arithmetic:
bf16 operands, f32 sums, the softmax weights rounded to bf16 before they meet
v, dS rounded to bf16 before it meets k and q, and dV taken from the
unnormalised dropped weights and dO scaled by inv_keep / l, both rounded,
which is where the TPU kernel rounds too (ops/fused_attention.py:94,
:140-141, :156). The card-only tests hold the kernels against the same
statement.

On random inputs the two agree within bounds that the rounding itself would
also pass, so those cases check the algebra in bf16. Where the rounding
falls is told by the last four cases, on inputs whose unrounded answer
cancels: there the statement equals the Pallas kernels to the bit (dq, dk,
dv) or far closer than without its rounding (out).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textreact_tpu.ops.fused_attention import \
    fused_dropout_attention as jax_attention
from textreact_tpu_torch.ops import fused_attention

BF16_ULP = 2.0 ** -7  # relative spacing of bf16 just above a power of two

# bf16 on both sides. Each side rounds its f32 result to bf16 (half an ulp
# each, so one ulp of the value apart at worst: the relative term), and the
# two take their exp and sums in another order, so an intermediate weight or
# dS near a rounding boundary may round the other way, a relative 2^-9 on
# terms whose sum is of order 1: the absolute term
OUT_TOL = dict(atol=1e-2, rtol=BF16_ULP)
GRAD_TOL = dict(atol=2e-2, rtol=2 * BF16_ULP)
# the statement in f32 against autograd through the plain version: the same
# algebra, summation order only
F32_TOL = dict(atol=2e-5, rtol=1e-4)


def _inputs(B, L, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, H, D), dtype=np.float32)
            for _ in range(4)]


def _mask(B, L, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "none":
        return None
    mask = np.zeros((B, L), np.int32)
    if kind == "prefix":  # ragged, the last row a collator dummy
        for b in range(B - 1):
            mask[b, :rng.integers(L // 4, L + 1)] = 1
    else:                 # holes anywhere, first 16 keys masked
        mask[:] = rng.random((B, L)) < 0.6
        mask[:, :16] = 0
        mask[-1] = 0
    return mask


def _jax_keep(rng, B, H, L, p):
    """The keep mask the JAX wrapper draws host-side in interpret mode."""
    seed = jax.random.randint(rng, (1,), 0, jnp.iinfo(jnp.int32).max,
                              dtype=jnp.int32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), seed[0])
    return np.array(jax.random.uniform(key, (B, H, L, L)) >= p)


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


@pytest.mark.parametrize("H,D", [(2, 64), (4, 32)])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["prefix", "holes", "none"])
def test_rounding_statement_matches_pallas_kernels_in_bf16(H, D, p, kind):
    B, L = 3, 128
    q, k, v, do = _inputs(B, L, H, D, seed=H + D)
    mask = _mask(B, L, kind)
    scale = 1.0 / np.sqrt(D)
    rng = jax.random.PRNGKey(3)
    jmask = None if mask is None else jnp.asarray(mask)
    jdo = jnp.asarray(do, dtype=jnp.bfloat16)

    def jloss(q, k, v):
        out = jax_attention(q, k, v, jmask, p, rng, sm_scale=scale)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(jnp.asarray(t, dtype=jnp.bfloat16) for t in (q, k, v)))
    keep = torch.from_numpy(_jax_keep(rng, B, H, L, p)) if p > 0.0 else None
    got = fused_attention.attention_rounding_reference(
        _bf16(q), _bf16(k), _bf16(v), _bf16(do),
        None if mask is None else torch.from_numpy(mask), scale, keep, p)
    assert all(t.dtype == torch.bfloat16 and torch.isfinite(t).all()
               for t in got)
    want = [np.asarray(t.astype(jnp.float32)) for t in (jout, *jgrads)]
    np.testing.assert_allclose(got[0].float().numpy(), want[0], **OUT_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.float().numpy(), w, **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.25])
@pytest.mark.parametrize("kind", ["prefix", "holes", "none"])
def test_rounding_statement_in_f32_is_autograd_of_the_plain_version(causal, p,
                                                                    kind):
    """With nothing to round, the statement's hand-written backward is the
    gradient of `attention_reference`."""
    B, L, H, D = 3, 128, 2, 32
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(B, L, H, D, seed=7))
    mask = _mask(B, L, kind, seed=1)
    mask = None if mask is None else torch.from_numpy(mask)
    keep = None
    if p > 0.0:
        keep = torch.rand((B, H, L, L),
                          generator=torch.Generator().manual_seed(2)) >= p
    scale = D ** -0.5
    got = fused_attention.attention_rounding_reference(
        q, k, v, do, mask, scale, keep, p, causal=causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = fused_attention.attention_reference(*leaves, mask, scale, keep, p,
                                              causal=causal)
    ref.backward(do)
    torch.testing.assert_close(got[0], ref.detach(), **F32_TOL)
    for g, leaf in zip(got[1:], leaves):
        torch.testing.assert_close(g, leaf.grad, **F32_TOL)


def test_rounding_statement_forward_is_the_plain_version_in_bf16():
    """Same rounding point in the forward: equal to the bit."""
    B, L, H, D = 2, 128, 2, 64
    q, k, v, do = (_bf16(t) for t in _inputs(B, L, H, D, seed=9))
    mask = torch.from_numpy(_mask(B, L, "prefix"))
    keep = torch.rand((B, H, L, L),
                      generator=torch.Generator().manual_seed(4)) >= 0.1
    out = fused_attention.attention_rounding_reference(
        q, k, v, do, mask, D ** -0.5, keep, 0.1)[0]
    ref = fused_attention.attention_reference(q, k, v, mask, D ** -0.5, keep,
                                              0.1)
    assert torch.equal(out, ref)


def test_rounding_dS_to_bf16_moves_gradients_by_less_than_the_card_bound():
    """How far the kernels' rounding of dS and of the dropped probabilities
    moves dq, dk, dv from autograd through the plain version (which keeps
    both in f32): inside the bound the card-only tests and the smoke run
    hold the bf16 kernels to, atol 3e-2 + rtol 2^-6."""
    B, L, H, D = 2, 256, 2, 64
    q, k, v, do = (_bf16(t) for t in _inputs(B, L, H, D, seed=11))
    mask = torch.from_numpy(_mask(B, L, "prefix"))
    keep = torch.rand((B, H, L, L),
                      generator=torch.Generator().manual_seed(6)) >= 0.1
    got = fused_attention.attention_rounding_reference(
        q, k, v, do, mask, D ** -0.5, keep, 0.1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fused_attention.attention_reference(*leaves, mask, D ** -0.5, keep,
                                        0.1).backward(do)
    for g, leaf in zip(got[1:], leaves):
        ref = leaf.grad.float()
        excess = (g.float() - ref).abs() - 3e-2 - 2.0 ** -6 * ref.abs()
        assert float(excess.max()) <= 0.0


# The four cases below tell where the rounding falls, which the bounds above
# cannot (rounding dS or the weights moves a result by less than they allow).
# Each builds inputs on which the unrounded answer cancels, so that the
# rounding of single terms is all that is left, and holds the statement with
# bf16 inputs (which rounds) and with the same values as f32 inputs (which
# does not) against the Pallas kernels with bf16 inputs.


def _pallas(q, k, v, do, scale, mask=None):
    """(out, dq, dk, dv) of the Pallas kernels in interpret mode on bf16
    inputs, without dropout, as f32 torch tensors."""
    jdo = jnp.asarray(do, dtype=jnp.bfloat16).astype(jnp.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(q, k, v):
        out = jax_attention(q, k, v, jmask, 0.0, None, sm_scale=scale)
        return jnp.sum(out.astype(jnp.float32) * jdo), out

    (_, out), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(t, dtype=jnp.bfloat16) for t in (q, k, v)))
    return [torch.from_numpy(np.array(t.astype(jnp.float32)))
            for t in (out, *grads)]


def _zero_sum_integers(rng, B, L, H, D, high):
    """Small integers (exact in bf16) around [-high, high] whose sum over
    the rows is 0 in every column: the rounded column mean is taken off
    every row and what is left of the sum, at most L / 2, one by one off the
    first rows."""
    x = rng.integers(-high, high + 1, (B, L, H, D))
    x -= np.rint(x.sum(1, keepdims=True) / L).astype(x.dtype)
    rest = x.sum(1, keepdims=True)
    rows = np.arange(L)[None, :, None, None]
    x -= np.sign(rest) * (rows < np.abs(rest))
    assert not x.sum(1).any() and np.abs(x).max() < 2 * high
    return x.astype(np.float32)


@pytest.mark.parametrize("which", ["dq", "dk"])
def test_rounding_of_dS_falls_where_the_pallas_kernel_rounds(which):
    """Zero scores make every weight 1 / L, and integer v and dO whose
    columns sum to zero make out and delta zero, so dS = dO v^T * scale / L
    is the same f32 number on both sides whatever the order of the sums
    (integers of up to 11 bits, more than bf16 holds), and its rows and
    columns sum to zero. A column of ones in k (for dq; in q
    for dk) then reads the sum of a row (column) of dS: exactly 0 where dS is
    kept in f32, and the sum of the bf16 rounding errors where it is
    rounded. The statement equals the Pallas kernel there to the bit, and is
    not zero; the statement without its rounding is zero."""
    B, L, H, D = 2, 128, 2, 64
    rng = np.random.default_rng(5)
    v = _zero_sum_integers(rng, B, L, H, D, 15)
    do = _zero_sum_integers(rng, B, L, H, D, 15)
    ones = np.zeros((B, L, H, D), np.float32)
    ones[..., 0] = 1.0
    zeros = np.zeros_like(ones)
    q, k = (zeros, ones) if which == "dq" else (ones, zeros)
    index = 1 if which == "dq" else 2
    scale = D ** -0.5   # a power of two
    want = _pallas(q, k, v, do, scale)[index][..., 0]
    args = [torch.from_numpy(t) for t in (q, k, v, do)]
    rounded = fused_attention.attention_rounding_reference(
        *(t.bfloat16() for t in args), None, scale)[index][..., 0].float()
    unrounded = fused_attention.attention_rounding_reference(
        *args, None, scale)[index][..., 0]
    assert float((want != 0).float().mean()) > 0.5
    assert torch.equal(rounded, want)
    assert not unrounded.any()


def test_rounding_of_the_weights_falls_where_the_pallas_kernel_rounds():
    """Small scores keep the weights near 1, and a column of v that
    alternates between 1 and -1 cancels them, so what the rounding of each
    weight to bf16 leaves (2^-9 of a weight, over 128 keys) is a tenth of
    the answer and far above the answer's own bf16 spacing. The statement
    then lies much closer to the Pallas forward than the statement without
    its rounding does: not to the bit, because the two sides' exp differ in
    the last place and a weight on a rounding boundary may fall either
    way."""
    B, L, H, D = 2, 128, 2, 64
    rng = np.random.default_rng(6)
    q, k = (0.3 * rng.standard_normal((B, L, H, D), dtype=np.float32)
            for _ in range(2))
    v = np.zeros((B, L, H, D), np.float32)
    v[:, 0::2, :, 0], v[:, 1::2, :, 0] = 1.0, -1.0
    scale = D ** -0.5
    # both sides start from the bf16 values
    q, k = (torch.from_numpy(t).bfloat16().float().numpy() for t in (q, k))
    want = _pallas(q, k, v, v, scale)[0][..., 0]
    args = [torch.from_numpy(t) for t in (q, k, v, v)]
    rounded = fused_attention.attention_rounding_reference(
        *(t.bfloat16() for t in args), None, scale)[0][..., 0].float()
    unrounded = fused_attention.attention_rounding_reference(
        *args, None, scale)[0][..., 0].bfloat16().float()
    near = float((rounded - want).abs().mean())
    far = float((unrounded - want).abs().mean())
    assert far > 0 and near < 0.1 * far, (near, far)


def test_rounding_of_dv_falls_where_the_pallas_kernel_rounds():
    """Zero scores under a key mask make every valid key's weight exactly 1
    and l the count of valid keys (100 and 77: no power of two, so 1 / l and
    dO / l are not exact in bf16). dv of a valid key is then the sum over
    the queries of round(dO / l); integer dO whose columns sum to zero make
    the unrounded answer vanish, and what is left is the sum of the
    roundings. Every term is a bf16 number between 2^-7 and 2^-1 and the sum
    stays below 2^6, so f32 adds them exactly in any order: the statement
    equals the Pallas kernel to the bit. Rounding the normalised weights
    instead, round(1 / l) times the sum of dO, gives exactly zero, and the
    statement without its rounding nearly zero."""
    B, L, H, D = 2, 128, 2, 64
    rng = np.random.default_rng(8)
    do = _zero_sum_integers(rng, B, L, H, D, 15)
    v = rng.integers(-4, 5, (B, L, H, D)).astype(np.float32)
    q = k = np.zeros((B, L, H, D), np.float32)
    mask = np.zeros((B, L), np.int32)
    mask[0, :100], mask[1, 5:82] = 1, 1
    scale = D ** -0.5
    want = _pallas(q, k, v, do, scale, mask)[3]
    args = [torch.from_numpy(t) for t in (q, k, v, do)]
    rounded = fused_attention.attention_rounding_reference(
        *(t.bfloat16() for t in args), torch.from_numpy(mask),
        scale)[3].float()
    unrounded = fused_attention.attention_rounding_reference(
        *args, torch.from_numpy(mask), scale)[3]
    valid = torch.from_numpy(mask > 0)[:, :, None, None].expand_as(want)
    assert float((want[valid] != 0).float().mean()) > 0.5
    assert not want[~valid].any()
    assert torch.equal(rounded, want)
    counts = torch.from_numpy(mask.sum(1).astype(np.float32))
    normalised_first = (1.0 / counts).bfloat16().float()[:, None, None, None] \
        * torch.from_numpy(do).sum(1, keepdim=True)
    assert not normalised_first.any()
    assert float(unrounded.abs().max()) < 1e-3 * float(want.abs().max())
