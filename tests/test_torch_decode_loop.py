"""The port's device-state decode loop against the JAX package, on the CPU:
the decode step at a tensor position, `beam_search` with its state on the
device (stops inside each window of a schedule), the body's no-op past a
stop, the launch accounting of captured graphs, and the route under
tensor parallelism.

Models and batches are tests/test_torch_beam_decode.py's (hidden 32, f32,
flax params converted with `from_flax`); the logit tables are
tests/test_torch_generate.py's, drawn from seeded numpy generators.
"""

import _torch_threads  # noqa: F401  (before torch runs)
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_beam_decode import STEP_TOL, TINY_DEC, _batch, _models
from test_torch_generate import BOS, EOS, PAD, TABLES
from textreact_tpu.inference.beam import ancestor_bias as jax_ancestor_bias
from textreact_tpu.inference.beam import beam_search as jax_beam_search
from textreact_tpu.models import DecoderStep as JaxDecoderStep
from textreact_tpu_torch.entry import _flagship, _generate_inputs
from textreact_tpu_torch.inference import Generator, beam_search, decode_route
from textreact_tpu_torch.inference.beam import (BeamState, StopFlags,
                                                ancestor_bias, beam_step,
                                                run_windows, window_plan)
from textreact_tpu_torch.inference.graphs import GraphLaunches
from textreact_tpu_torch.models import DecoderStep
from textreact_tpu_torch.parallel.multihost import spawn

HERE = os.path.dirname(os.path.abspath(__file__))
# scores of the scripted tables: sums of <= 11 f32 log-probs, summed in the
# same order on both sides (test_torch_generate's bound)
SCORE_RTOL = 1e-6
# tp=2 against one device, f32: the row-split products are summed across
# ranks in another order (the JAX gate's bound, entry._GATE_BOUND)
TP_BOUND = 1e-5


# --- (a) the decode step at a tensor position --------------------------------

def test_step_at_a_tensor_position_equals_the_int_position_and_jax():
    """Random tokens and parents a step, windows 2, 4, T: the grouped step
    at a 0-d tensor position equals the step at the int position to the
    bit (logits and every cache tensor), and the JAX grouped step within
    STEP_TOL (test_torch_beam_decode (c)'s bound)."""
    B, K, T = 2, 3, 5
    jmodel, params, tmodel = _models(0)
    batch = _batch()
    ids, mask = batch["input_ids"], batch["attention_mask"]
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, TINY_DEC.vocab_size, (T, B * K)).astype(np.int32)
    parents = rng.integers(0, K, (T, B, K))
    enc_j = jmodel.apply(params, method="encode", input_ids=ids,
                         attention_mask=mask)
    step_params = {"params": {"decoder": params["params"]["decoder"]}}
    jstep = JaxDecoderStep(decoder_config=TINY_DEC, dtype=jnp.float32,
                           cache_len=T, beam_groups=K)
    _, cv = jstep.apply(step_params, jnp.zeros((B * K, 1), jnp.int32), enc_j,
                        mask, 0, mutable=["cache"])
    jcache = cv["cache"]
    step = DecoderStep(tmodel.decoder, beam_groups=K)
    t_mask = torch.as_tensor(mask)
    src = np.zeros((B, K, T), dtype=np.int64)
    with torch.no_grad():
        enc = tmodel.encode(torch.as_tensor(ids, dtype=torch.long), t_mask)
        at_int = step.init_cache(enc, t_mask, K, T)
        at_tensor = step.init_cache(enc, t_mask, K, T)
        for t in range(T - 1):
            W = min(w for w in (2, 4, T) if t + 1 <= w)
            src[:, :, t] = np.arange(K)
            tok = torch.as_tensor(tokens[t][:, None], dtype=torch.long)
            bias = ancestor_bias(torch.as_tensor(src[:, :, :W]), t + 1, B, K,
                                 W)
            want = step(tok, at_int, t, bias)
            got = step(tok, at_tensor, torch.tensor(t), bias)
            assert torch.equal(got, want), f"step {t}"
            for a, b in zip(at_int.self_k + at_int.self_v,
                            at_tensor.self_k + at_tensor.self_v):
                assert torch.equal(a, b), f"cache, step {t}"
            jlogits, vo = jstep.apply(
                {**step_params, "cache": jcache},
                jnp.asarray(tokens[t][:, None]), enc_j, mask, t,
                jax_ancestor_bias(jnp.asarray(src[:, :, :W], jnp.int32),
                                  jnp.asarray(t + 1), B, K, W),
                mutable=["cache"])
            jcache = vo["cache"]
            np.testing.assert_allclose(got[:, 0].numpy(),
                                       np.asarray(jlogits[:, 0]),
                                       rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=f"JAX, step {t}")
            src = src[np.arange(B)[:, None], parents[t]]


def test_per_row_step_at_a_tensor_position():
    """The per-row cache (the JAX package's beam_groups=0 twin) at a 0-d
    tensor position reads all T slots under the JAX bias that masks those
    past it; at the int position it reads the prefix. Masked slots add
    exact zeros, so the two agree within f32 summation order (1e-6), and
    their caches to the bit."""
    K, T = 3, 6
    _, _, tmodel = _models(7)
    batch = _batch()
    rng = np.random.default_rng(2)
    tokens = rng.integers(1, TINY_DEC.vocab_size, (T, 2 * K))
    step = DecoderStep(tmodel.decoder)
    t_mask = torch.as_tensor(batch["attention_mask"])
    with torch.no_grad():
        enc = tmodel.encode(torch.as_tensor(batch["input_ids"],
                                            dtype=torch.long), t_mask)
        at_int = step.init_cache(enc, t_mask, K, T)
        at_tensor = step.init_cache(enc, t_mask, K, T)
        for t in range(T):
            tok = torch.as_tensor(tokens[t][:, None])
            want = step(tok, at_int, t)
            got = step(tok, at_tensor, torch.tensor(t))
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
            for a, b in zip(at_int.self_k + at_int.self_v,
                            at_tensor.self_k + at_tensor.self_v):
                assert torch.equal(a, b)


# --- (b) beam_search with its state on the device ----------------------------

T_WIN = 16
WINDOWS = [4, 8, T_WIN]


def _eos_from(step: int, V: int = 6) -> np.ndarray:
    """A table over T_WIN positions whose best token is 3 before `step` and
    EOS from it on, each at log-prob ~0, the others far below."""
    table = np.full((T_WIN, V), -8.0)
    table[:step, 3] = 0.0
    table[:step, 4] = -1.0
    table[step:, EOS] = 0.0
    table[step:, 3] = -0.5
    return table


# name -> (table, K, B, attn_windows): the scripted tables in one window,
# then a stop inside each window of [4, 8, T_WIN]
CASES = {name: (table, K, B, None) for name, (table, K, B) in TABLES.items()}
CASES.update({f"stop_in_window_{i}": (_eos_from(s), 2, 2, WINDOWS)
              for i, s in enumerate((1, 5, 9))})


def _jax_search(table, K, B, windows):
    """(seqs, scores, steps) of the JAX beam_search: each step's call of
    step_fn is counted through jax.debug.callback."""
    calls = []
    t = jnp.asarray(table, jnp.float32)

    def step_fn(cache, tokens, pos, bias):
        jax.debug.callback(lambda p: calls.append(int(p)), pos)
        return jnp.tile(t[pos][None, None, :], (tokens.shape[0], 1, 1)), cache

    seqs, scores = jax_beam_search(step_fn, {}, B, K, table.shape[0], BOS,
                                   EOS, PAD, attn_windows=windows)
    seqs, scores = np.asarray(seqs), np.asarray(scores)
    jax.effects_barrier()
    return seqs, scores, len(calls)


def _torch_step(table, positions):
    t = torch.as_tensor(table, dtype=torch.float32)

    def step_fn(tokens, pos, bias):
        assert isinstance(pos, torch.Tensor) and pos.dim() == 0
        positions.append(int(pos))
        return t[pos][None, None, :].expand(tokens.shape[0], 1, -1)

    return step_fn


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_state_beam_search_matches_jax(name):
    """Sequences equal, scores within SCORE_RTOL, the same step count; the
    step function sees positions 0, 1, ... as 0-d tensors, once each (on
    the CPU the flag is read after every step, so no step runs past a
    stop)."""
    table, K, B, windows = CASES[name]
    T = table.shape[0]
    jseqs, jscores, jsteps = _jax_search(table, K, B, windows)
    positions = []
    seqs, scores, steps = beam_search(_torch_step(table, positions), B, K, T,
                                      BOS, EOS, PAD, attn_windows=windows)
    np.testing.assert_array_equal(seqs.numpy(), jseqs)
    np.testing.assert_allclose(scores.numpy(), jscores, rtol=SCORE_RTOL)
    assert steps == jsteps and positions == list(range(steps))
    if windows is not None:   # EOS stops it inside the window it names
        i = int(name[-1])
        lo, hi = ([0] + windows)[i], windows[i]
        assert lo < steps + 1 <= hi and steps + 1 < T, steps


def test_window_plan_counts_each_windows_steps():
    """Without a stop each window runs from its start to its width (the
    last one to T - 1), and the counts sum to T - 1."""
    for T in range(1, 200):
        for user in (None, [4, 8], [T - 1, T], [1]):
            plan = window_plan(T, user)
            assert sum(w.steps for w in plan) == max(0, T - 1), (T, user)
            assert [w.last for w in plan] == [False] * (len(plan) - 1) + [True]
    assert [(w.width, w.steps) for w in window_plan(160)] == [
        (48, 48), (80, 32), (160, 79)]


# --- (c) past the stop, the body changes nothing -----------------------------

@pytest.mark.parametrize("name", ["stop_in_window_1", "no_eos", "greedy"])
def test_steps_past_the_stop_change_no_state(name):
    """Run the search to its stop, then the body 1, 2 and 5 more times in
    each window: every state tensor keeps its bits. no_eos runs to
    cur_len == T, where the body's write of the new token is clamped to
    the last slot and discarded."""
    table, K, B, windows = CASES[name]
    T = table.shape[0]
    state = BeamState.allocate(B, K, T)
    state.reset(BOS, PAD)
    plan = window_plan(T, windows)
    positions = []
    step_fn = _torch_step(table, positions)
    run_windows(plan, lambda i: beam_step(state, step_fn, plan[i], EOS),
                StopFlags(state.done))
    assert bool(state.done)
    if name == "no_eos":
        assert int(state.cur_len) == T
    before = [t.clone() for t in state.tensors()]
    for window in plan:
        for extra in (1, 2, 5):
            for _ in range(extra):
                beam_step(state, step_fn, window, EOS)
            for got, want in zip(state.tensors(), before):
                assert torch.equal(got, want), (window, extra)


# --- (d) the launch accounting of a captured graph ---------------------------

def test_graph_launches_take_back_a_capture_and_add_its_replays():
    """Fake counters: an int and a dict, as the wrappers keep them. What a
    capture counts is taken back; n replays add n times its launches;
    launches outside a capture stand."""
    ops = types.SimpleNamespace(LAUNCHES=5, PADDED={"fwd": 1, "bwd": 0})
    other = types.SimpleNamespace(LAUNCHES=0)
    counters = ((ops, "LAUNCHES"), (ops, "PADDED"), (other, "LAUNCHES"))
    launches = GraphLaunches(counters)
    with launches.capturing():
        ops.LAUNCHES += 3
        ops.PADDED["fwd"] += 2
    assert (ops.LAUNCHES, ops.PADDED, other.LAUNCHES) == (5, {"fwd": 1,
                                                              "bwd": 0}, 0)
    launches.replayed()
    assert (ops.LAUNCHES, ops.PADDED["fwd"]) == (8, 3)
    ops.LAUNCHES += 1          # an uncaptured launch
    launches.replayed(4)
    assert (ops.LAUNCHES, ops.PADDED, other.LAUNCHES) == (21, {"fwd": 11,
                                                               "bwd": 0}, 0)
    second = GraphLaunches(counters)
    with second.capturing():
        other.LAUNCHES += 7
    second.replayed(2)
    launches.replayed(0)
    assert (ops.LAUNCHES, other.LAUNCHES) == (21, 14)


# --- (e) tensor parallelism takes the uncaptured route -----------------------

def test_route_is_chosen_from_the_device_and_the_tp_group():
    assert decode_route(torch.device("cuda"), 1) == "cuda_graphs"
    assert decode_route(torch.device("cuda"), 2) == "uncaptured"
    assert decode_route(torch.device("cpu"), 1) == "uncaptured"


def test_tp_generation_takes_the_uncaptured_route_and_equals_one_device(
        tmp_path):
    """Two ranks over gloo on the CPU, the decoder cut tp=2: the route is
    the uncaptured loop, the sequences equal one device's and the scores
    agree within TP_BOUND."""
    spawn("_torch_decode_worker:tp_generate", 2, {"out": str(tmp_path)},
          pythonpath=[HERE])
    got = json.loads((tmp_path / "generate.json").read_text())
    module = _flagship(tiny=True, dtype=torch.float32, seed=2)
    gen = Generator(module, num_beams=3, max_length=8)
    seqs, scores = gen.generate(_generate_inputs(module))
    assert got["route"] == "uncaptured" and got["tp"] == 2
    assert got["steps"] == gen.last_steps
    np.testing.assert_array_equal(np.asarray(got["seqs"]), seqs)
    np.testing.assert_allclose(np.asarray(got["scores"]), scores,
                               rtol=TP_BOUND, atol=TP_BOUND)
