"""The port's row-stable beam decode against the JAX package, on the CPU:
the ancestor bias, the static window schedule, the grouped beam cache
(DecoderStep(beam_groups=K)) under arbitrary beam reorderings, and the
Generator's window invariance.

The model is tests/test_models.py's TINY pair (hidden 32, 4 heads of 8,
plain attention and LayerNorm on both sides), float32, its flax params
converted into the port with `from_flax`; inputs are drawn from seeded
numpy generators.
"""

import _torch_threads  # noqa: F401  (before torch runs)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import port_config
from textreact_tpu.inference.beam import _plan_windows as jax_plan_windows
from textreact_tpu.inference.beam import ancestor_bias as jax_ancestor_bias
from textreact_tpu.inference.predictor import Generator as JaxGenerator
from textreact_tpu.models import DecoderStep as JaxDecoderStep
from textreact_tpu.models import EncoderDecoder as JaxEncoderDecoder
from textreact_tpu.models import TransformerConfig as JaxConfig
from textreact_tpu_torch.inference import Generator
from textreact_tpu_torch.inference.beam import _plan_windows, ancestor_bias
from textreact_tpu_torch.models import (DecoderStep, EncoderDecoder,
                                        from_flax)

TINY_ENC = JaxConfig(
    vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=64, max_position_embeddings=64, type_vocab_size=1)
TINY_DEC = TINY_ENC.replace(vocab_size=32, is_decoder=True,
                            add_cross_attention=True,
                            max_position_embeddings=32)
# f32 through 2 decoder layers; the grouped path sums its softmax over
# G*W slots (the masked ones add exact zeros) where the per-row path sums
# over t, and the packages differ in summation order: the JAX test's bound
STEP_TOL = 2e-4
# window invariance and the JAX Generator: identical sequences, and log-prob
# sums of <= 11 steps within f32 rounding (the JAX test's bounds)
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6


def _batch(B=2, L=16, Ld=8):
    rng = np.random.default_rng(0)
    return dict(
        input_ids=rng.integers(1, 64, (B, L)).astype(np.int32),
        attention_mask=np.ones((B, L), dtype=np.int32),
        decoder_input_ids=rng.integers(1, 32, (B, Ld)).astype(np.int32),
        decoder_attention_mask=np.ones((B, Ld), dtype=np.int32),
    )


def _models(seed):
    """(JAX module, its params, the port's module with those params)."""
    jmodel = JaxEncoderDecoder(encoder_config=TINY_ENC,
                               decoder_config=TINY_DEC, dtype=jnp.float32)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    params = jmodel.init(jax.random.PRNGKey(seed), **batch)
    tmodel = EncoderDecoder(port_config(TINY_ENC), port_config(TINY_DEC),
                            dtype=torch.float32)
    tmodel.load_state_dict(from_flax(jax.device_get(params)))
    return jmodel, params, tmodel.eval()


# --- (a) the ancestor bias ---------------------------------------------------

@pytest.mark.parametrize("B,K,T", [(1, 1, 1), (2, 3, 5), (3, 5, 48),
                                   (4, 20, 16), (2, 20, 160)])
def test_ancestor_bias_equals_jax(B, K, T):
    """Random ancestor tables and lengths: the same (B, K, T*K) f32 bias,
    to the bit."""
    rng = np.random.default_rng(B * 1000 + K * 10 + T)
    for _ in range(4):
        src = rng.integers(0, K, (B, K, T)).astype(np.int32)
        cur_len = int(rng.integers(1, T + 1))
        want = np.asarray(jax_ancestor_bias(jnp.asarray(src),
                                            jnp.asarray(cur_len), B, K, T))
        got = ancestor_bias(torch.as_tensor(src, dtype=torch.long), cur_len,
                            B, K, T)
        assert got.dtype == torch.float32 and got.shape == (B, K, T * K)
        np.testing.assert_array_equal(got.numpy(), want)


# --- (b) the window schedule -------------------------------------------------

@pytest.mark.parametrize("user", ["none", "4,8,T", "T", "300", "16,64",
                                  "1"])
def test_plan_windows_equals_jax(user):
    """T = 1..200 with no user schedule (quarter and half windows rounded
    up to multiples of 16, then T) and with user lists."""
    for T in range(1, 201):
        if user == "none":
            ws = None
        else:
            ws = [T if w == "T" else int(w) for w in user.split(",")]
        got = _plan_windows(T, ws)
        assert got == jax_plan_windows(T, ws), (T, ws)
        assert got[-1] == T and got == sorted(set(got))
    assert _plan_windows(160, None) == [48, 80, 160]
    assert _plan_windows(16, None) == [16]


# --- (c) the grouped cache under random reorderings --------------------------

def _window_for(cur_len, T, schedule):
    return T if schedule == "full" else min(w for w in (2, 4, T)
                                            if cur_len <= w)


@pytest.mark.parametrize("schedule", ["full", "windows"])
@pytest.mark.parametrize("seed", [0, 7])
def test_grouped_step_matches_jax_and_the_permuted_cache(seed, schedule):
    """Twin of tests/test_models.py::
    test_ancestry_beam_attention_matches_permuted_cache. Random tokens and
    random parents a step: the port's grouped DecoderStep against the JAX
    grouped DecoderStep, step by step, and against the port's per-row
    DecoderStep whose cache rows are moved to the parents after each step
    (row j of both then holds the same hypothesis). 'windows' narrows the
    bias to the windows 2, 4, T as the beam search does."""
    B, K, T = 2, 3, 5
    jmodel, params, tmodel = _models(seed)
    batch = _batch()
    ids, mask = batch["input_ids"], batch["attention_mask"]
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, TINY_DEC.vocab_size, (T, B * K)).astype(np.int32)
    parents = rng.integers(0, K, (T, B, K))

    # the JAX package's grouped step
    enc_j = jmodel.apply(params, method="encode", input_ids=ids,
                         attention_mask=mask)
    step_params = {"params": {"decoder": params["params"]["decoder"]}}
    jstep = JaxDecoderStep(decoder_config=TINY_DEC, dtype=jnp.float32,
                           cache_len=T, beam_groups=K)
    _, cv = jstep.apply(step_params, jnp.zeros((B * K, 1), jnp.int32), enc_j,
                        mask, 0, mutable=["cache"])
    jcache = cv["cache"]

    # the port's grouped and per-row steps
    grouped = DecoderStep(tmodel.decoder, beam_groups=K)
    per_row = DecoderStep(tmodel.decoder)
    t_ids = torch.as_tensor(ids, dtype=torch.long)
    t_mask = torch.as_tensor(mask)
    flat_base = np.arange(B)[:, None] * K
    src = np.zeros((B, K, T), dtype=np.int64)
    with torch.no_grad():
        enc = tmodel.encode(t_ids, t_mask)
        gcache = grouped.init_cache(enc, t_mask, K, T)
        rcache = per_row.init_cache(enc, t_mask, K, T)
        for t in range(T - 1):
            W = _window_for(t + 1, T, schedule)
            src[:, :, t] = np.arange(K)
            tok = torch.as_tensor(tokens[t][:, None], dtype=torch.long)
            bias = ancestor_bias(torch.as_tensor(src[:, :, :W]), t + 1, B, K,
                                 W)
            got = grouped(tok, gcache, t, bias)[:, 0].numpy()
            jlogits, vo = jstep.apply(
                {**step_params, "cache": jcache},
                jnp.asarray(tokens[t][:, None]), enc_j, mask, t,
                jax_ancestor_bias(jnp.asarray(src[:, :, :W], jnp.int32),
                                  jnp.asarray(t + 1), B, K, W),
                mutable=["cache"])
            jcache = vo["cache"]
            np.testing.assert_allclose(got, np.asarray(jlogits[:, 0]),
                                       rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=f"JAX, step {t}")
            want = per_row(tok, rcache, t)[:, 0].numpy()
            np.testing.assert_allclose(got, want, rtol=STEP_TOL,
                                       atol=STEP_TOL,
                                       err_msg=f"per-row cache, step {t}")
            rows = torch.as_tensor((flat_base + parents[t]).reshape(-1))
            rcache.self_k = [c[rows] for c in rcache.self_k]
            rcache.self_v = [c[rows] for c in rcache.self_v]
            src = src[np.arange(B)[:, None], parents[t]]


# --- (d) the window schedule leaves generation unchanged ---------------------

T_GEN, K_GEN = 12, 3
WINDOWS = {"one": [T_GEN], "three": [4, 8, T_GEN]}


@pytest.fixture(scope="module")
def generated():
    """{schedule: (JAX (seqs, scores), port (seqs, scores))} on the JAX
    test's model (PRNGKey(11)), beam 3 over 12 positions."""
    jmodel, params, tmodel = _models(11)
    batch = _batch()
    inputs = {"input_ids": batch["input_ids"],
              "attention_mask": batch["attention_mask"]}
    out = {}
    for name, ws in WINDOWS.items():
        jres = JaxGenerator(jmodel, params, num_beams=K_GEN,
                            max_length=T_GEN, attn_windows=ws).generate(
            inputs)
        gen = Generator(tmodel, num_beams=K_GEN, max_length=T_GEN,
                        attn_windows=ws)
        out[name] = (jres, gen.generate(inputs), gen.last_steps)
    return out


def test_segmented_attention_windows_are_invariant(generated):
    """Twin of tests/test_models.py::
    test_segmented_attention_windows_are_invariant on the port: windows
    [T] and [4, 8, T] give the same sequences and scores."""
    _, (ref_s, ref_sc), ref_steps = generated["one"]
    _, (seg_s, seg_sc), seg_steps = generated["three"]
    assert ref_steps == seg_steps and ref_steps > 8   # every window ran
    np.testing.assert_array_equal(seg_s, ref_s)
    np.testing.assert_allclose(seg_sc, ref_sc, rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)


@pytest.mark.parametrize("schedule", sorted(WINDOWS))
def test_windowed_generator_matches_jax(generated, schedule):
    (jseqs, jscores), (seqs, scores), _ = generated[schedule]
    assert seqs.shape == (2, K_GEN, T_GEN)
    np.testing.assert_array_equal(seqs, np.asarray(jseqs))
    np.testing.assert_allclose(scores, np.asarray(jscores), rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)
