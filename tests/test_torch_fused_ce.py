"""The port's chunked linear + cross-entropy against the JAX package's, on
the CPU: the same numpy inputs through both, float32."""

import _torch_threads  # noqa: F401  (before torch runs)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textreact_tpu.ops.fused_ce import fused_linear_ce as jax_fused_ce
from textreact_tpu_torch.ops.fused_ce import fused_linear_ce

# f32 on both sides, the same chunking, so the two differ by the order of
# sums inside a matmul and a log-sum-exp: values of order 10 (sum_nll over
# ~20 rows of a 37-way softmax), gradients of order 1
RTOL, ATOL = 1e-5, 2e-5
IGNORE = -100
N, D, V = 24, 16, 37


def _inputs(vocab_axis, seed=0, all_ignored=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D), dtype=np.float32)
    w = rng.standard_normal((D, V), dtype=np.float32) * 0.5
    if vocab_axis == 0:
        w = np.ascontiguousarray(w.T)
    b = rng.standard_normal(V, dtype=np.float32) * 0.1
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[rng.random(N) < 0.3] = IGNORE
    labels[0], labels[1] = V - 1, 0   # first and last vocab rows
    if all_ignored:
        labels[:] = IGNORE
    return x, w, b, labels


def _jax(x, w, b, labels, vocab_axis, chunk, weight=1.0):
    def loss(x, w, b):
        s, n = jax_fused_ce(x, w, b, jnp.asarray(labels), IGNORE, vocab_axis,
                            chunk)
        return weight * s, (s, n)
    (_, (s, n)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                            has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return float(s), int(n), [np.asarray(g) for g in grads]


def _port(x, w, b, labels, vocab_axis, chunk, weight=1.0):
    leaves = [torch.from_numpy(t.copy()).requires_grad_() for t in (x, w, b)]
    s, n = fused_linear_ce(*leaves, torch.from_numpy(labels), IGNORE,
                           vocab_axis, chunk)
    (weight * s).backward()
    return float(s.detach()), int(n), [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("vocab_axis", [0, 1])
@pytest.mark.parametrize("chunk", [16, 4096])
def test_values_and_gradients_match_jax(vocab_axis, chunk):
    args = _inputs(vocab_axis)
    js, jn, jgrads = _jax(*args, vocab_axis, chunk, weight=0.7)
    ts, tn, tgrads = _port(*args, vocab_axis, chunk, weight=0.7)
    assert tn == jn == int((args[3] != IGNORE).sum())
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
    for name, tg, jg in zip(("dx", "dw", "db"), tgrads, jgrads):
        assert tg.shape == jg.shape, name
        np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("vocab_axis", [0, 1])
def test_matches_torch_cross_entropy(vocab_axis):
    x, w, b, labels = _inputs(vocab_axis, seed=3)
    ts, tn, tgrads = _port(x, w, b, labels, vocab_axis, 16)
    leaves = [torch.from_numpy(t.copy()).requires_grad_() for t in (x, w, b)]
    wt = leaves[1] if vocab_axis == 1 else leaves[1].t()
    ref = torch.nn.functional.cross_entropy(
        leaves[0] @ wt + leaves[2], torch.from_numpy(labels).long(),
        ignore_index=IGNORE, reduction="sum")
    ref.backward()
    np.testing.assert_allclose(ts, float(ref), rtol=RTOL, atol=ATOL)
    for tg, leaf in zip(tgrads, leaves):
        np.testing.assert_allclose(tg, leaf.grad.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("vocab_axis", [0, 1])
def test_all_ignored_rows_give_zero_loss_and_zero_gradients(vocab_axis):
    args = _inputs(vocab_axis, all_ignored=True)
    js, jn, _ = _jax(*args, vocab_axis, 16)
    ts, tn, tgrads = _port(*args, vocab_axis, 16)
    assert (ts, tn) == (0.0, 0) and (js, jn) == (0.0, 0)
    for tg in tgrads:
        assert np.isfinite(tg).all() and not tg.any()


def test_bf16_operands_keep_a_float32_loss():
    x, w, b, labels = _inputs(1, seed=5)
    s32, _, _ = _port(x, w, b, labels, 1, 16)
    leaves = [torch.from_numpy(x).bfloat16().requires_grad_(),
              torch.from_numpy(w).requires_grad_(),
              torch.from_numpy(b).requires_grad_()]
    s, n = fused_linear_ce(*leaves, torch.from_numpy(labels), IGNORE, 1, 16)
    s.backward()
    assert s.dtype == torch.float32 and n.dtype == torch.int32
    assert leaves[0].grad.dtype == torch.bfloat16
    assert leaves[1].grad.dtype == torch.float32
    # operands rounded to bf16 (2^-9 relative each), accumulated in f32
    np.testing.assert_allclose(float(s), s32, rtol=2e-2)
