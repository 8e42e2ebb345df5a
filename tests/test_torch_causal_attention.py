"""The port's causal attention against the JAX package, on the CPU, float32.

The JAX side is `textreact_tpu.models.layers._flash_attention` (the stock
Pallas TPU flash kernel, causal, key mask as segment ids) run under
`pltpu.force_tpu_interpret_mode()`, as tests/test_models.py runs Pallas on
the CPU; the port's side is the plain version of its causal kernels
(`attention_reference(causal=True)`, which `causal_attention` takes for a CPU
tensor). The kernels themselves are held against that plain version on the
card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import _torch_threads  # noqa: F401  (before torch runs)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from textreact_tpu.models import TransformerConfig as JaxConfig
from textreact_tpu.models.layers import MultiHeadAttention as JaxAttention
from textreact_tpu.models.layers import TransformerBlock as JaxBlock
from textreact_tpu.models.layers import _flash_attention
from textreact_tpu_torch.models import TransformerConfig, from_flax
from textreact_tpu_torch.models.layers import (MultiHeadAttention,
                                               TransformerBlock)
from textreact_tpu_torch.ops import fused_attention
from textreact_tpu_torch.ops.fused_attention import (attention_reference,
                                                     causal_attention)

# against the Pallas kernel in interpret mode: the tolerance of the JAX
# package's own flash test (tests/test_models.py)
FLASH_TOL = 5e-3
# against the JAX plain path: f32 on both sides, summation order only
PLAIN_TOL = 1e-5
B = 3


def _inputs(L, D, seed=0, H=2):
    """q, k, v, the cotangent and a ragged right-padded key mask (row 0
    full, the others cut), from numpy."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, L, H, D)).astype(np.float32)
                  for _ in range(4))
    lengths = np.array([L, L // 2 + 3, 17])
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
    return q, k, v, g, mask, lengths


def _real_rows(arr, lengths):
    """Rows of real queries only: (sum(lengths), H, D)."""
    return np.concatenate([arr[b, :n] for b, n in enumerate(lengths)])


def _jax_plain(q, k, v, mask, D):
    """The JAX package's plain causal path: what MultiHeadAttention computes
    after its projections with attention_impl='xla', causal_hint and
    mask_kv (layers.py:225-230 and the einsum path below it)."""
    from textreact_tpu.models.layers import causal_bias, mask_to_bias
    bias = mask_to_bias(mask) + causal_bias(q.shape[1], k.shape[1])
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / jnp.sqrt(float(D))
    probs = jax.nn.softmax(s + bias, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", probs, v)


@pytest.mark.parametrize("D", [32, 64, 96, 48])
@pytest.mark.parametrize("L", [128, 256])
def test_plain_version_matches_flash_kernel_in_interpret_mode(L, D):
    q, k, v, _, mask, lengths = _inputs(L, D, seed=L + D)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
            True, D ** -0.5))
    got = causal_attention(*(torch.tensor(a) for a in (q, k, v)),
                           torch.tensor(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(_real_rows(got, lengths),
                               _real_rows(want, lengths),
                               rtol=FLASH_TOL, atol=FLASH_TOL)
    plain = np.asarray(_jax_plain(*(jnp.asarray(a) for a in (q, k, v)),
                                  jnp.asarray(mask), D))
    np.testing.assert_allclose(_real_rows(got, lengths),
                               _real_rows(plain, lengths),
                               rtol=PLAIN_TOL, atol=PLAIN_TOL)


@pytest.mark.parametrize("D", [32, 64, 96])
@pytest.mark.parametrize("L", [128, 256])
def test_gradients_match_flash_kernel_in_interpret_mode(L, D):
    """dq, dk, dv against `jax.grad` through `_flash_attention` itself, in
    interpret mode (its three Pallas kernels run on the CPU in a few
    seconds at these sizes), and against `jax.grad` of the JAX plain path.
    The cotangent is zero on padded query rows, as a loss gives it."""
    q, k, v, g, mask, lengths = _inputs(L, D, seed=L - D)
    g = g * mask[:, :, None, None]
    jq, jk, jv, jg, jmask = (jnp.asarray(a) for a in (q, k, v, g, mask))

    def loss(fn):
        return lambda a, b, c: jnp.sum(fn(a, b, c) * jg)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss(lambda a, b, c: _flash_attention(
            a, b, c, jmask, True, D ** -0.5)), argnums=(0, 1, 2))(jq, jk, jv)
    plain = jax.grad(loss(lambda a, b, c: _jax_plain(a, b, c, jmask, D)),
                     argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = causal_attention(*leaves, torch.tensor(mask))
    out.backward(torch.tensor(g))
    for leaf, w, p in zip(leaves, want, plain):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=FLASH_TOL, atol=FLASH_TOL)
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(p),
                                   rtol=1e-4, atol=PLAIN_TOL)


def test_plain_version_semantics():
    """A key above the diagonal has weight exactly 0 whatever the key mask
    says; a row whose visible keys are all masked is uniform over them and
    finite; without a mask row 0 copies v[0]."""
    L, D = 128, 32
    q, k, v, _, mask, _ = _inputs(L, D)
    mask[2] = 0                                   # a dummy row
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    out = attention_reference(tq, tk, tv, torch.tensor(mask), D ** -0.5,
                              causal=True)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[2, 4], tv[2, :5].mean(0),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out[:, 0], tv[:, 0], rtol=1e-6, atol=1e-6)
    k2, v2 = tk.clone(), tv.clone()
    k2[:, 50:] = 9.0
    v2[:, 50:] = -9.0
    out2 = attention_reference(tq, k2, v2, torch.tensor(mask), D ** -0.5,
                               causal=True)
    assert torch.equal(out[:, :50], out2[:, :50])
    # and the non-causal function is unchanged by the new argument
    a = attention_reference(tq, tk, tv, torch.tensor(mask), D ** -0.5)
    b = attention_reference(tq, tk, tv, torch.tensor(mask), D ** -0.5,
                            causal=False)
    assert torch.equal(a, b)


def _configs(**kw):
    base = dict(vocab_size=40, hidden_size=128, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=256,
                max_position_embeddings=256, is_decoder=True,
                add_cross_attention=True, attention_impl="flash",
                layernorm_impl="fused")
    base.update(kw)
    cfg = JaxConfig(**base)
    return cfg, TransformerConfig(**dataclasses.asdict(cfg))


def _numpy_params(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return jnp.asarray(1.0 + 0.1 * noise if path[-1].key == "scale"
                           else 0.05 * noise)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("L,impl", [(128, "flash"), (256, "flash"),
                                    (160, "flash"), (96, "flash"),
                                    (128, "xla")])
def test_causal_block_matches_jax(L, impl):
    """TransformerBlock(causal=True) with converted weights against the JAX
    block: aligned lengths take the flash kernel there (interpret mode) and
    the causal branch here; 160 (retro's decoder length) and 96 are not
    multiples of 128 and take the plain path in both, as does
    attention_impl='xla'. self_bias=None, a ragged self_mask, encoder states
    of length 128 under the key bias of their own ragged mask, as the
    decoder passes it (so the cross-attention takes the plain path in both
    packages: without a bias and with unequal aligned lengths the JAX
    package's fused call cannot reshape its output, and the port's wrapper
    raises). Compared on real rows."""
    jcfg, tcfg = _configs(attention_impl=impl)
    rng = np.random.default_rng(L)
    x = rng.standard_normal((B, L, 128)).astype(np.float32)
    enc = rng.standard_normal((B, 128, 128)).astype(np.float32)
    lengths = np.array([L, L // 2 + 3, 17])
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
    enc_mask = (np.arange(128)[None] < np.array([128, 60, 99])[:, None])
    cross_bias = np.where(enc_mask, 0.0, -1e9).astype(
        np.float32)[:, None, None, :]
    jblock = JaxBlock(jcfg, dtype=jnp.float32, causal=True)
    args = (jnp.asarray(x), None, jnp.asarray(enc), jnp.asarray(cross_bias),
            True, jnp.asarray(mask))
    shapes = jax.eval_shape(
        lambda: jblock.init(jax.random.PRNGKey(0), *args))
    params = _numpy_params(shapes, seed=L)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jblock.apply(params, *args))
    tblock = TransformerBlock(tcfg, torch.float32, causal=True).eval()
    tblock.load_state_dict(from_flax(jax.device_get(params)))
    before = (fused_attention.CAUSAL_LAUNCHES, fused_attention.LAUNCHES)
    with torch.no_grad():
        got = tblock(torch.tensor(x), self_bias=None,
                     encoder_states=torch.tensor(enc),
                     cross_bias=torch.tensor(cross_bias),
                     self_mask=torch.tensor(mask)).numpy()
    # a CPU tensor never counts as a launch
    assert (fused_attention.CAUSAL_LAUNCHES,
            fused_attention.LAUNCHES) == before
    tol = FLASH_TOL if (impl == "flash" and L % 128 == 0) else 1e-4
    np.testing.assert_allclose(_real_rows(got, lengths),
                               _real_rows(want, lengths), rtol=tol, atol=tol)


def test_causal_hint_without_mask_is_not_causal_on_the_plain_path():
    """The quirk of the reference, mirrored as it stands (layers.py:225-230):
    the plain path adds the causal bias only inside `if mask_kv is not
    None`. With causal_hint, no mask and an unaligned length, both packages
    attend over every key."""
    jcfg, tcfg = _configs(add_cross_attention=False)
    L = 96
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, L, 128)).astype(np.float32)
    jattn = JaxAttention(jcfg, dtype=jnp.float32, causal_hint=True)
    shapes = jax.eval_shape(
        lambda: jattn.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = _numpy_params(shapes, seed=7)
    tattn = MultiHeadAttention(tcfg, torch.float32, causal_hint=True).eval()
    tattn.load_state_dict(from_flax(jax.device_get(params)))
    ones = np.ones((2, L), np.int32)
    for mask, causal in ((None, False), (ones, True)):
        want = np.asarray(jattn.apply(
            params, jnp.asarray(x),
            mask_kv=None if mask is None else jnp.asarray(mask)))
        with torch.no_grad():
            got = tattn(torch.tensor(x), mask_kv=None if mask is None
                        else torch.tensor(mask)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        # causal iff row 0 ignores a change of the later inputs
        x2 = x.copy()
        x2[:, 1:] += 1.0
        with torch.no_grad():
            moved = tattn(torch.tensor(x2), mask_kv=None if mask is None
                          else torch.tensor(mask)).numpy()
        assert np.allclose(moved[:, 0], got[:, 0], atol=1e-6) == causal


def test_causal_branch_conditions_and_no_attention_dropout(monkeypatch):
    """MultiHeadAttention takes the causal call under the JAX package's own
    condition (attention_impl 'flash', no bias, aligned lengths,
    causal_hint), and in training mode that branch draws no
    attention-probability mask (layers.py:218-220 ignores drop_p): the
    generator is not advanced and two passes agree to the bit."""
    _, tcfg = _configs(add_cross_attention=False,
                       attention_probs_dropout_prob=0.5)
    calls = []
    real = fused_attention.causal_attention

    def spy(*a, **k):
        calls.append(a[0].shape[1])
        return real(*a, **k)

    import textreact_tpu_torch.models.layers as layers
    monkeypatch.setattr(layers, "causal_attention", spy)
    attn = MultiHeadAttention(tcfg, torch.float32, causal_hint=True).train()
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    x = torch.randn(2, 128, 128)
    mask = torch.ones(2, 128, dtype=torch.int32)
    a = attn(x, mask_kv=mask, generator=gen)
    b = attn(x, mask_kv=mask, generator=gen)
    assert calls == [128, 128]
    assert torch.equal(a, b) and torch.equal(gen.get_state(), state)
    # declined: a bias, an unaligned length, the plain implementation, or
    # no hint
    attn(x, bias=torch.zeros(1, 1, 128, 128), mask_kv=mask, generator=gen)
    attn(x[:, :96], mask_kv=mask[:, :96], generator=gen)
    attn.config = tcfg.replace(attention_impl="xla")
    attn(x, mask_kv=mask, generator=gen)
    plain = MultiHeadAttention(tcfg, torch.float32).train()
    plain(x, mask_kv=mask, generator=gen)
    assert calls == [128, 128]
    # those paths do draw a mask at p = 0.5
    assert not torch.equal(gen.get_state(), state)
