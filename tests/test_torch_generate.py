"""Port beam search and generation against the JAX package, on the CPU.

Beam search is held on fixed per-step logit tables (ties included); the
Generator on a model whose Pallas kernels run in interpret mode on the JAX
side (hidden 128, encoder length 128), with flax params converted into the
port. Sequences must be identical; scores agree to float32 rounding.
"""

import _torch_threads  # noqa: F401  (before torch runs)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import (jax_configs, make_batch, port_config,
                               random_params)
from textreact_tpu.inference.beam import beam_search as jax_beam_search
from textreact_tpu.inference.predictor import Generator as JaxGenerator
from textreact_tpu.inference.predictor import \
    predictions_from_beams as jax_predictions_from_beams
from textreact_tpu.models import EncoderDecoder as JaxEncoderDecoder
from textreact_tpu.tokenizers import ConditionTokenizer
from textreact_tpu_torch.inference import (Generator, beam_search,
                                           predictions_from_beams)
from textreact_tpu_torch.inference.beam import top_k
from textreact_tpu_torch.models import EncoderDecoder, from_flax

BOS, EOS, PAD = 0, 1, 2
# log-prob sums over <= 12 steps in f32; the model's logits differ by
# summation order only (see test_torch_models)
SCORE_RTOL = 1e-5


def _tables():
    V = 6
    greedy = np.full((4, V), -10.0)
    greedy[0, 3] = 0.0
    greedy[1:, EOS] = 0.0
    sums = np.full((3, V), -100.0)
    sums[0, 3], sums[0, 4], sums[1, EOS] = 2.0, 1.0, 0.0
    early = np.zeros((4, V))
    early[0] = [-100, -0.5, -100, -1.2, -100, -100]
    early[1] = [-100, -0.1, -100, -100, -100, -100]
    no_eos = np.zeros((5, V))
    no_eos[:, EOS] = -1000.0
    dropped = np.full((4, V), -100.0)
    dropped[0, 3], dropped[0, 4], dropped[0, EOS] = 0.1, 0.0, -0.1
    dropped[1:, [0, 3, 4, 5]] = 0.0
    rng = np.random.default_rng(0)
    rand = rng.normal(size=(6, V))
    rand[:, EOS] += 1.0
    # ties: a coarse grid of logits, and V=4 with K=3 (2K > V) where every
    # token is equally likely, so whole candidate sets tie exactly
    grid = np.round(rng.normal(size=(6, V)) * 2) / 2
    flat4 = np.zeros((6, 4))
    return {
        "greedy": (greedy, 1, 2), "logprob_sums": (sums, 2, 1),
        "early_eos": (early, 2, 1), "no_eos": (no_eos, 3, 1),
        "eos_beyond_k_dropped": (dropped, 2, 1), "random": (rand, 3, 3),
        "ties_grid": (grid, 4, 2), "ties_small_vocab": (flat4, 3, 2),
    }


TABLES = _tables()


def _jax_step(table):
    t = jnp.asarray(table, jnp.float32)
    return lambda cache, tokens, pos, bias: (
        jnp.tile(t[pos][None, None, :], (tokens.shape[0], 1, 1)), cache)


def _torch_step(table):
    t = torch.as_tensor(table, dtype=torch.float32)
    return lambda tokens, pos, bias: t[pos][None, None, :].expand(
        tokens.shape[0], 1, -1)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_beam_search_matches_jax(name):
    table, K, B = TABLES[name]
    T = table.shape[0]
    jseqs, jscores = jax_beam_search(_jax_step(table), {}, B, K, T, BOS, EOS,
                                     PAD)
    seqs, scores, steps = beam_search(_torch_step(table), B, K, T, BOS, EOS,
                                      PAD)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(jseqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-6)
    assert 1 <= steps <= T - 1


def test_top_k_ties_go_to_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = top_k(x, 4)
    assert idx.tolist() == [[1, 2, 3, 5]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert np.asarray(ji).tolist() == idx.tolist()


@pytest.fixture(scope="module", params=[(40, 3, 10), (6, 4, 8)],
                ids=["V40-K3", "V6-K4-ties"])
def generated(request):
    """(JAX (seqs, scores), port (seqs, scores), K) on make_batch() with a
    decoder vocab of V; at V=6, K=4 the 2K candidates exceed V, so the
    start's -1e7 beams tie exactly."""
    V, K, T = request.param
    enc, dec = jax_configs(2)
    dec = dec.replace(vocab_size=V)
    jmodel = JaxEncoderDecoder(encoder_config=enc, decoder_config=dec,
                               dtype=jnp.float32)
    batch = make_batch()
    params = random_params(jmodel, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, seed=1)
    inputs = {"input_ids": batch["input_ids"],
              "attention_mask": batch["attention_mask"]}
    jres = JaxGenerator(jmodel, params, num_beams=K,
                        max_length=T).generate(inputs)
    tmodel = EncoderDecoder(port_config(enc), port_config(dec),
                            dtype=torch.float32)
    tmodel.load_state_dict(from_flax(jax.device_get(params)))
    gen = Generator(tmodel.eval(), num_beams=K, max_length=T)
    return jres, gen.generate(inputs), K


def test_generator_matches_jax(generated):
    (jseqs, jscores), (seqs, scores), K = generated
    assert seqs.shape == jseqs.shape and scores.shape == (3, K)
    np.testing.assert_array_equal(seqs, jseqs)
    np.testing.assert_allclose(scores, jscores, rtol=SCORE_RTOL)
    assert np.isfinite(scores).all()
    assert (np.diff(scores, axis=1) <= 0).all()


def test_predictions_from_beams_matches_jax(generated):
    _, (seqs, scores), _ = generated
    tok = ConditionTokenizer()
    indices = np.array([7, 8, -1])
    example_mask = np.array([1, 1, 0])
    got = predictions_from_beams(seqs, scores, indices, example_mask, tok)
    assert got == jax_predictions_from_beams(seqs, scores, indices,
                                             example_mask, tok)
    assert sorted(got) == [7, 8]
