"""Port kernel ops against the JAX package's Pallas kernels, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (the default on the
CPU backend); the port's wrappers take their plain PyTorch versions on CPU
tensors. Same numpy inputs on both sides, float32.
"""

import _torch_threads  # noqa: F401  (before torch runs)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textreact_tpu.ops.fused_attention import \
    fused_dropout_attention as jax_attention
from textreact_tpu.ops.fused_layernorm import \
    fused_residual_layernorm as jax_layernorm
from textreact_tpu_torch.ops import fused_attention, fused_layernorm

# f32 on both sides; the two differ only in summation order (an einsum
# against the interpret-mode dot, a reduction order in the softmax and LN
# statistics), a few f32 ulps of values of order 1
ATOL = RTOL = 2e-5


def _qkv(B, L, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, H, D), dtype=np.float32)
            for _ in range(3)]


def _ragged_mask(B, L, seed=0):
    """Ragged key-padding mask whose last row is a dummy (all keys masked),
    as the collator pads a short batch."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, L), np.int32)
    for b in range(B - 1):
        mask[b, :rng.integers(L // 4, L + 1)] = 1
    return mask


@pytest.mark.parametrize("H,D", [(2, 64), (4, 32), (2, 96), (4, 48)])
@pytest.mark.parametrize("masked", [True, False])
def test_attention_matches_pallas_kernel(H, D, masked):
    B, L = 3, 128
    q, k, v = _qkv(B, L, H, D)
    mask = _ragged_mask(B, L) if masked else None
    scale = 1.0 / np.sqrt(D)
    ref = np.asarray(jax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), 0.0, None,
        sm_scale=scale))
    got = fused_attention.fused_dropout_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), 0.0, None,
        sm_scale=scale)
    assert got.shape == (B, L, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_attention_dummy_row_is_finite_average_of_values():
    """-1e9 (not -inf) on masked keys: a row with every key masked gives
    the plain mean of v, never NaN."""
    B, L, H, D = 2, 128, 2, 64
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, L, H, D, seed=1))
    mask = torch.ones(B, L, dtype=torch.int32)
    mask[1] = 0
    out = fused_attention.fused_dropout_attention(q, k, v, mask)
    assert torch.isfinite(out).all()
    expect = v[1].mean(dim=0, keepdim=True).expand(L, H, D)
    torch.testing.assert_close(out[1], expect, rtol=RTOL, atol=ATOL)


def test_attention_dropout_plain_path_rescales_kept_weights():
    """p > 0 on the CPU: the reference's mask from the same generator, with
    the normaliser over the undropped weights and 1/(1-p) on kept ones."""
    B, L, H, D = 1, 128, 2, 32
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, L, H, D, seed=2))
    p = 0.25
    got = fused_attention.fused_dropout_attention(
        q, k, v, None, p, torch.Generator().manual_seed(5))
    keep = torch.rand((B, H, L, L),
                      generator=torch.Generator().manual_seed(5)) >= p
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D)
    probs = torch.softmax(s, -1) * keep / (1 - p)
    expect = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    torch.testing.assert_close(got, expect, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("H", [128, 768, 2048])
@pytest.mark.parametrize("R", [6, 64])
def test_residual_layernorm_matches_pallas_kernel(R, H):
    rng = np.random.default_rng(R + H)
    x = rng.standard_normal((R, H), dtype=np.float32)
    y = rng.standard_normal((R, H), dtype=np.float32) * 0.5 + 1.0
    scale = rng.uniform(0.5, 1.5, H).astype(np.float32)
    bias = rng.standard_normal(H, dtype=np.float32) * 0.1
    eps = 1e-5
    ref = np.asarray(jax_layernorm(jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(scale), jnp.asarray(bias), eps))
    got = fused_layernorm.fused_residual_layernorm(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(scale),
        torch.from_numpy(bias), eps)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_layernorm_fast_variance_clamps_at_zero():
    """A constant row: E[z^2] - E[z]^2 may round below 0; the clamp keeps
    rsqrt finite and the output equals the bias, as in flax."""
    x = torch.full((4, 128), 3.1, dtype=torch.float32)
    y = torch.full((4, 128), 0.7, dtype=torch.float32)
    bias = torch.linspace(-1, 1, 128)
    out = fused_layernorm.fused_residual_layernorm(
        x, y, torch.ones(128), bias, 1e-5)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, bias.expand(4, 128), rtol=0, atol=1e-3)


def test_layernorm_keeps_bf16_input_dtype():
    x = torch.randn(8, 128, generator=torch.Generator().manual_seed(0))
    out = fused_layernorm.fused_residual_layernorm(
        x.bfloat16(), x.bfloat16(), torch.ones(128), torch.zeros(128), 1e-5)
    assert out.dtype == torch.bfloat16


def test_layernorm_dropout_plain_path_rescales_kept_residual():
    x = torch.randn(4, 128, generator=torch.Generator().manual_seed(1))
    y = torch.randn(4, 128, generator=torch.Generator().manual_seed(2))
    p = 0.3
    got = fused_layernorm.fused_residual_layernorm(
        x, y, torch.ones(128), torch.zeros(128), 1e-5, p,
        torch.Generator().manual_seed(9))
    keep = torch.rand((4, 128), generator=torch.Generator().manual_seed(9)) >= p
    expect = fused_layernorm.residual_layernorm_reference(
        x, torch.where(keep, y / (1 - p), 0.0), torch.ones(128),
        torch.zeros(128), 1e-5)
    torch.testing.assert_close(got, expect, rtol=RTOL, atol=ATOL)


# --- gradients, and dropout with a shared keep mask -------------------------
# jax.grad runs through the interpret-mode Pallas backward kernels; the port
# runs autograd through its plain versions. f32 on both sides, summation
# order only; gradients sum up to 128 terms of size ~1, hence 1e-4
GRAD_ATOL = GRAD_RTOL = 1e-4


def _jax_attention_keep(rng, B, H, L, p):
    """The keep mask the JAX wrapper draws host-side in interpret mode
    (ops/fused_attention.py:193-194 with the seed of :305-306)."""
    import jax
    seed = jax.random.randint(rng, (1,), 0, jnp.iinfo(jnp.int32).max,
                              dtype=jnp.int32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), seed[0])
    return np.array(jax.random.uniform(key, (B, H, L, L)) >= p)


def _jax_layernorm_keep(rng, R, H, p):
    """ops/fused_layernorm.py:117-118 with the seed of :245-246."""
    import jax
    seed = jax.random.randint(rng, (1,), 0, jnp.iinfo(jnp.int32).max,
                              dtype=jnp.int32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), seed[0])
    return np.array(jax.random.uniform(key, (R, H)) >= p)


@pytest.mark.parametrize("H,D", [(2, 64), (4, 32), (2, 96), (4, 48)])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_attention_forward_and_gradients_match_pallas_kernels(H, D, p):
    import jax
    B, L = 3, 128
    q, k, v = _qkv(B, L, H, D, seed=1)
    do = np.random.default_rng(2).standard_normal((B, L, H, D),
                                                  dtype=np.float32)
    mask = _ragged_mask(B, L)
    scale = 1.0 / np.sqrt(D)
    rng = jax.random.PRNGKey(5)

    def jloss(q, k, v):
        out = jax_attention(q, k, v, jnp.asarray(mask), p, rng,
                            sm_scale=scale)
        return jnp.sum(out * do), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    keep = (torch.from_numpy(_jax_attention_keep(rng, B, H, L, p))
            if p > 0.0 else None)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = fused_attention.fused_dropout_attention(
        *leaves, torch.from_numpy(mask), p, None, sm_scale=scale, keep=keep)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    for leaf, jg in zip(leaves, jgrads):
        assert torch.isfinite(leaf.grad).all()
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_attention_cpu_dropout_draws_from_the_generator():
    q, k, v = (torch.from_numpy(t) for t in _qkv(2, 128, 2, 32))
    g = torch.Generator().manual_seed(3)
    a = fused_attention.fused_dropout_attention(q, k, v, None, 0.5, g)
    g.manual_seed(3)
    b = fused_attention.fused_dropout_attention(q, k, v, None, 0.5, g)
    c = fused_attention.fused_dropout_attention(q, k, v, None, 0.5, g)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the normaliser runs over the undropped weights: dropping changes a
    # row by less than the row's weight, never renormalises
    none = fused_attention.fused_dropout_attention(q, k, v, None, 0.0)
    assert not torch.allclose(a, none)


@pytest.mark.parametrize("R,H", [(64, 128), (24, 256), (16, 2048)])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_layernorm_forward_and_gradients_match_pallas_kernels(R, H, p):
    import jax
    rng_np = np.random.default_rng(R + H)
    x = rng_np.standard_normal((R, H), dtype=np.float32)
    y = rng_np.standard_normal((R, H), dtype=np.float32) * 0.5 + 1.0
    g = rng_np.standard_normal((R, H), dtype=np.float32)
    scale = 1.0 + 0.1 * rng_np.standard_normal(H, dtype=np.float32)
    bias = 0.1 * rng_np.standard_normal(H, dtype=np.float32)
    rng = jax.random.PRNGKey(9)

    def jloss(x, y, scale, bias):
        out = jax_layernorm(x, y, scale, bias, 1e-5, dropout_p=p,
                            dropout_rng=rng)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        *(jnp.asarray(t) for t in (x, y, scale, bias)))
    keep = (torch.from_numpy(_jax_layernorm_keep(rng, R, H, p))
            if p > 0.0 else None)
    leaves = [torch.from_numpy(t).requires_grad_()
              for t in (x, y, scale, bias)]
    out = fused_layernorm.fused_residual_layernorm(*leaves, 1e-5, p, None,
                                                   keep=keep)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    for leaf, jg in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_layernorm_reference_keep_mask_scales_the_kept():
    x = torch.zeros(2, 128)
    y = torch.ones(2, 128)
    keep = torch.zeros(2, 128, dtype=torch.bool)
    keep[:, ::2] = True
    w, b = torch.ones(128), torch.zeros(128)
    out = fused_layernorm.residual_layernorm_reference(x, y, w, b, 1e-5,
                                                       keep, 0.5)
    # z alternates 2, 0: mean 1, variance 1
    torch.testing.assert_close(out[0, :2], torch.tensor([1.0, -1.0]),
                               rtol=1e-4, atol=1e-4)


def test_dropout_threshold_is_the_jax_kernels_rule():
    from textreact_tpu_torch.ops import _build
    assert _build.dropout_threshold(0.0) == 0
    assert _build.dropout_threshold(0.1) == int(0.1 * (1 << 32))
    assert _build.dropout_threshold(1.0) == (1 << 32) - 1
