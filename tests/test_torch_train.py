"""The port's training slice against the JAX package's, on the CPU.

Losses, schedule and clip one by one; then the slice as a whole: the same
collated batch and the same weights (through `from_flax`) go through
`textreact_tpu.train.step` and `textreact_tpu_torch.train.step` in float32
with both dropout probabilities at 0 (the two frameworks cannot share
dropout bits): loss, MLM loss, gradient norm, every gradient, every
parameter after 3 steps, accumulation with a weight-0 micro-batch, and the
eval step. The JAX side runs its Pallas kernels in interpret mode
(`attention_impl="flash"`, `layernorm_impl="fused"`); the port runs its
plain versions under autograd, as it does for any CPU tensor.
"""

import _torch_threads  # noqa: F401  (before torch runs)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import textreact_tpu.config as jax_config
import textreact_tpu.train.losses as jax_losses
import textreact_tpu.train.optim as jax_optim
import textreact_tpu.train.step as jax_step
from textreact_tpu.models import EncoderDecoder as JaxEncoderDecoder
from textreact_tpu.models import TransformerConfig as JaxConfig
from textreact_tpu_torch.config import ExperimentConfig
from textreact_tpu_torch.data import Collator
from textreact_tpu_torch.models import (EncoderDecoder, TransformerConfig,
                                        from_flax, grads_from_flax)
from textreact_tpu_torch.train import (TrainState, losses,
                                       make_accum_train_step, make_eval_step,
                                       make_loss_fn, make_optimizer,
                                       make_train_step, optim)

# f32 on both sides; values of order 1-10 that differ by summation order
RTOL, ATOL = 1e-5, 2e-5


# --- (d) losses -------------------------------------------------------------

def _logits_labels(seed=0, B=4, T=9, V=11, pad=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2.0
    ids = rng.integers(1, V, (B, T)).astype(np.int32)
    ids[1, 5:] = pad
    ids[3, 1:] = pad          # a row with nothing to predict
    return logits, ids


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_seq2seq_loss_matches_jax(smoothing, reduction):
    logits, ids = _logits_labels()
    ref = jax_losses.seq2seq_loss(jnp.asarray(logits), jnp.asarray(ids), 0,
                                  smoothing, reduction)
    got = losses.seq2seq_loss(torch.from_numpy(logits), torch.from_numpy(ids),
                              0, smoothing, reduction)
    assert got.shape == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_seq2seq_greedy_acc_matches_jax():
    logits, ids = _logits_labels(seed=1)
    # make row 0 exactly right, so both values of the metric occur
    for t in range(ids.shape[1] - 1):
        logits[0, t, ids[0, t + 1]] = 50.0
    ref = jax_losses.seq2seq_greedy_acc(jnp.asarray(logits),
                                        jnp.asarray(ids), 0)
    got = losses.seq2seq_greedy_acc(torch.from_numpy(logits),
                                    torch.from_numpy(ids), 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[0] == 1.0 and got[2] == 0.0


def test_mlm_template_and_masked_probs_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 8, 13)).astype(np.float32)
    labels = rng.integers(0, 13, (3, 8)).astype(np.int32)
    labels[0, 4:] = -100
    labels[2] = -100
    bond_logits = rng.standard_normal((3, 6, 5)).astype(np.float32)
    bond_labels = rng.integers(0, 5, (3, 6)).astype(np.int32)
    bond_labels[1, 2:] = -100
    j = [jnp.asarray(t) for t in (logits, bond_logits, labels, bond_labels)]
    t = [torch.from_numpy(a) for a in (logits, bond_logits, labels,
                                       bond_labels)]
    np.testing.assert_allclose(
        losses.mlm_loss(t[0], t[2]).numpy(),
        np.asarray(jax_losses.mlm_loss(j[0], j[2])), rtol=RTOL, atol=ATOL)
    for reduction in ("mean", "none"):
        np.testing.assert_allclose(
            losses.template_loss(*t, reduction=reduction).numpy(),
            np.asarray(jax_losses.template_loss(*j, reduction=reduction)),
            rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        losses.masked_probs(t[0], t[2]).numpy(),
        np.asarray(jax_losses.masked_probs(j[0], j[2])), rtol=RTOL,
        atol=ATOL)
    # nothing valid anywhere: the mean divides by 1, not by 0
    none = torch.full((3, 8), -100, dtype=torch.int32)
    assert float(losses.mlm_loss(t[0], none)) == 0.0


# --- (d) schedule, (e) clip --------------------------------------------------

@pytest.mark.parametrize("scheduler", ["cosine", "constant"])
@pytest.mark.parametrize("warmup_ratio", [0.0, 0.1])
def test_lr_schedule_matches_jax(scheduler, warmup_ratio):
    kw = dict(lr=3e-4, scheduler=scheduler, warmup_ratio=warmup_ratio)
    steps = 50
    ref = jax_optim.lr_schedule(jax_config.ExperimentConfig(**kw), steps)
    got = optim.lr_schedule(ExperimentConfig(**kw), steps)
    warmup = int(steps * warmup_ratio)
    for step in sorted({0, max(warmup - 1, 0), warmup, steps // 2, steps - 1,
                        steps}):
        # the JAX schedule runs in float32 (the cosine near its zero keeps
        # ~7 digits of the rate, not of the value); the port's in float64
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6,
                                   atol=3e-4 * 1e-6, err_msg=str(step))
    if warmup:
        assert got(0) == 0.0 and got(warmup) == pytest.approx(3e-4)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["above", "below"])
def test_clip_matches_optax(max_norm):
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((4, 5), (7,), (2, 3, 2))]
    clip = optax.clip_by_global_norm(max_norm)
    ref, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(grads))
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = optim.global_norm(got)
    np.testing.assert_allclose(
        float(norm), float(optax.global_norm([jnp.asarray(g)
                                              for g in grads])), rtol=1e-6)
    optim.clip_by_global_norm(got, max_norm, norm)
    for g, r, raw in zip(got, ref, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
        if max_norm == 100.0:   # below the threshold: exactly untouched
            np.testing.assert_array_equal(g.numpy(), raw)


def test_adamw_decays_every_parameter_and_counts_from_zero():
    """optax.adamw semantics: weight decay on biases and LN too; the rate of
    update n is schedule(n), so a warmup's first update moves nothing."""
    cfg = ExperimentConfig(lr=1e-2, weight_decay=0.5, warmup_ratio=0.5,
                           scheduler="constant", max_grad_norm=1e9)
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer(cfg, 4, [("p", p)])
    p.grad = torch.zeros(3)
    opt.update()
    assert torch.equal(p.detach(), torch.ones(3)) and opt.count == 1
    p.grad = torch.zeros(3)
    opt.update()  # lr = 1e-2 * 1/2; a zero gradient leaves only the decay
    torch.testing.assert_close(p.detach(),
                               torch.full((3,), 1 - 0.005 * 0.5))


@pytest.mark.parametrize("fault", ["bare_parameters", "other_names",
                                   "other_shape"])
def test_optimizer_refuses_what_would_lose_its_moments(fault):
    """The optimizer takes named parameters only (the names key the saved
    moments), and a restore refuses moments of a parameter it does not
    hold or of another shape, leaving its state as it was."""
    cfg = ExperimentConfig(lr=1e-2, max_grad_norm=1e9)
    module = torch.nn.Linear(3, 2)
    if fault == "bare_parameters":
        with pytest.raises(TypeError, match="named_parameters"):
            make_optimizer(cfg, 4, module.parameters())
        return
    opt = make_optimizer(cfg, 4, module.named_parameters())
    module(torch.ones(1, 3)).sum().backward()
    opt.update()
    state = opt.state_dict()
    assert sorted(state["moments"]) == ["bias", "weight"]
    if fault == "other_names":
        state["moments"] = {str(i): m for i, m in enumerate(
            state["moments"].values())}
        error = KeyError
    else:
        m = state["moments"]["weight"]
        m["exp_avg"] = m["exp_avg_sq"] = torch.zeros(3, 2)
        error = ValueError
    fresh = make_optimizer(cfg, 4, module.named_parameters())
    with pytest.raises(error):
        fresh.load_state_dict(state)
    assert fresh.count == 0 and not fresh.adamw.state


# --- (f) the slice as a whole ------------------------------------------------

L, LD, ENC_V, DEC_V = 128, 16, 64, 40


def _jax_configs():
    enc = JaxConfig(vocab_size=ENC_V, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=256,
                    max_position_embeddings=L, type_vocab_size=2,
                    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                    attention_impl="flash", layernorm_impl="fused")
    dec = enc.replace(vocab_size=DEC_V, max_position_embeddings=32,
                      type_vocab_size=1, is_decoder=True,
                      add_cross_attention=True, bos_token_id=1,
                      eos_token_id=2, pad_token_id=0)
    return enc, dec


EXPERIMENT = dict(mlm=True, mlm_layer="mlp", mlm_lambda=0.1, lr=1e-3,
                  weight_decay=0.01, max_grad_norm=1.0, scheduler="cosine",
                  warmup_ratio=0.25, max_length=L, max_dec_length=LD,
                  compute_dtype="float32", label_smoothing=0.0)
NUM_STEPS = 4   # warmup = 1 update, so update 0 runs at rate 0


def _examples(n, seed):
    """Examples as the dataset builds them: a masked-first prefix of [MASK]
    ids with position_ids and labels, and a short decoder sequence."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(40, L + 1))
        n_mask = int(rng.integers(3, 20))
        ids = [4] * n_mask + [int(t) for t in rng.integers(5, ENC_V,
                                                           length - n_mask)]
        dec = [1] + [int(t) for t in rng.integers(3, DEC_V, 5)] + [2]
        out.append({
            "id": str(i), "index": i, "input_ids": ids,
            "attention_mask": [1] * length,
            "position_ids": [int(p) for p in rng.permutation(length)],
            "mlm_labels": [int(t) for t in rng.integers(5, ENC_V, n_mask)],
            "decoder_input_ids": dec,
            "decoder_attention_mask": [1] * len(dec)})
    return out


def _batch(n, seed, rows):
    """`n` examples collated into `rows` rows: the rest are the collator's
    dummy rows (every key masked, every label ignored)."""
    collate = Collator(ExperimentConfig(**EXPERIMENT), 0, 0)
    return collate(_examples(n, seed), fixed_batch=rows, fixed_enc_len=L,
                   fixed_dec_len=LD).arrays


def _random_params(module, batch, seed=0):
    shapes = jax.eval_shape(
        lambda b: module.init(jax.random.PRNGKey(0), b["input_ids"],
                              b["attention_mask"], b["decoder_input_ids"],
                              mlm_prefix_len=16), batch)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return jnp.asarray(1.0 + 0.1 * noise if path[-1].key == "scale"
                           else 0.05 * noise)

    return jax.tree_util.tree_map_with_path(draw, shapes)


class Pair:
    """The two packages' modules with the same weights, and their steps."""

    def __init__(self, **experiment):
        kw = dict(EXPERIMENT, **experiment)
        self.jcfg = jax_config.ExperimentConfig(**kw)
        self.cfg = ExperimentConfig(**kw)
        enc, dec = _jax_configs()
        self.jmodule = JaxEncoderDecoder(encoder_config=enc,
                                         decoder_config=dec,
                                         dtype=jnp.float32, mlm_layer="mlp")
        self.batch = _batch(3, seed=0, rows=4)
        self.params = _random_params(
            self.jmodule, {k: jnp.asarray(v) for k, v in self.batch.items()})
        self.module = EncoderDecoder(
            TransformerConfig(**dataclasses.asdict(enc)),
            TransformerConfig(**dataclasses.asdict(dec)),
            dtype=torch.float32, mlm_layer="mlp")
        self.module.load_state_dict(from_flax(jax.device_get(self.params)))
        self.tx = jax_optim.make_optimizer(self.jcfg, NUM_STEPS)
        self.optimizer = make_optimizer(self.cfg, NUM_STEPS,
                                        self.module.named_parameters())

    def compare_params(self, jparams, atol):
        ref = from_flax(jax.device_get(jparams))
        worst = 0.0
        for name, p in self.module.named_parameters():
            diff = float((p.detach() - ref[name]).abs().max())
            worst = max(worst, diff)
            assert diff <= atol, (name, diff)
        return worst


@pytest.fixture(scope="module")
def pair():
    return Pair()


def test_loss_and_every_gradient_match_jax(pair):
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()}
    jloss_fn = jax_step.make_loss_fn(pair.jmodule, pair.jcfg, 0)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jloss_fn, has_aux=True))(pair.params, jbatch, jax.random.PRNGKey(0))
    pair.module.train()
    pair.module.zero_grad()
    tbatch = {k: torch.as_tensor(v).long() for k, v in pair.batch.items()}
    loss, metrics = make_loss_fn(pair.module, pair.cfg, 0)(
        tbatch, torch.Generator().manual_seed(0))
    loss.backward()
    assert set(metrics) == set(jmetrics) == {"train_loss", "mlm_loss",
                                             "total_loss"}
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(jmetrics[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    ref = grads_from_flax(jax.device_get(jgrads))
    named = dict(pair.module.named_parameters())
    assert set(ref) == set(named)
    for name, p in named.items():
        # gradients of size up to ~1, sums over 4 x 128 positions
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   rtol=1e-4, atol=2e-5, err_msg=name)
    pair.module.zero_grad()
    pair.module.eval()


def test_mlm_impl_fused_matches_plain_in_the_port(pair):
    tbatch = {k: torch.as_tensor(v).long() for k, v in pair.batch.items()}
    pair.module.train()
    results = []
    for impl in ("fused", "xla"):
        cfg = dataclasses.replace(pair.cfg, mlm_impl=impl)
        pair.module.zero_grad()
        loss, metrics = make_loss_fn(pair.module, cfg, 0)(
            tbatch, torch.Generator().manual_seed(0))
        loss.backward()
        results.append((float(loss), float(metrics["mlm_loss"]),
                        pair.module.mlm_head.decoder.weight.grad.clone(),
                        pair.module.encoder.embeddings.word_embeddings
                        .weight.grad.clone()))
    pair.module.zero_grad()
    pair.module.eval()
    np.testing.assert_allclose(results[0][:2], results[1][:2], rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(results[0][2:], results[1][2:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_three_train_steps_match_jax():
    pair = Pair()
    state = jax_step.TrainState.create(pair.params, pair.tx)
    jstep = jax_step.make_train_step(pair.jmodule, pair.jcfg, pair.tx, 0)
    tstate = TrainState.create(pair.module, pair.optimizer)
    tstep = make_train_step(pair.module, pair.cfg, pair.optimizer, 0,
                            device="cpu")
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()}
    losses_seen = []
    for i in range(3):
        state, jm = jstep(state, jbatch, jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, pair.batch, 0)
        assert set(tm) == set(jm) == {"train_loss", "mlm_loss", "total_loss",
                                      "grad_norm"}
        for key in tm:
            # after an update the two parameter sets differ a little (see
            # below), and so do the metrics
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{key} step {i}")
        losses_seen.append(float(tm["total_loss"]))
    assert tstate.step == 3 and pair.optimizer.count == 3
    # update 0 ran at rate 0 (warmup), so the first two losses agree; the
    # third follows a real update
    assert losses_seen[0] == pytest.approx(losses_seen[1], abs=1e-6)
    assert losses_seen[2] < losses_seen[0]
    assert float(tm["grad_norm"]) > pair.cfg.max_grad_norm  # the clip bites
    # AdamW divides by sqrt(v) + eps: where a gradient is within rounding of
    # 0 the two sides' updates may differ by a fraction of the rate (1e-3),
    # hence 5e-5 (a twentieth of one update) for the worst element
    pair.compare_params(state.params, atol=5e-5)


def test_accumulation_with_a_weight_zero_microbatch_matches_jax():
    pair = Pair()
    real = [_batch(2, seed=s, rows=2) for s in (1, 2)]
    micro = {k: np.stack([real[0][k], real[1][k], real[1][k]])
             for k in real[0]}
    weights = np.array([1.0, 1.0, 0.0], np.float32)
    state = jax_step.TrainState.create(pair.params, pair.tx)
    jstep = jax_step.make_accum_train_step(pair.jmodule, pair.jcfg, pair.tx,
                                           0)
    tstate = TrainState.create(pair.module, pair.optimizer)
    tstep = make_accum_train_step(pair.module, pair.cfg, pair.optimizer, 0,
                                  device="cpu")
    jmicro = {k: jnp.asarray(v) for k, v in micro.items()}
    for i in range(2):   # update 0 at rate 0, update 1 real
        state, jm = jstep(state, jmicro, jnp.asarray(weights),
                          jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, micro, weights, 0)
        assert set(tm) == set(jm) == {"train_loss", "grad_norm"}
        for key in tm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{key} step {i}")
    pair.compare_params(state.params, atol=5e-5)
    # and the pad micro-batch is worth nothing: two real ones alone give
    # the port the same update
    other = Pair()
    ostep = make_accum_train_step(other.module, other.cfg, other.optimizer,
                                  0, device="cpu")
    ostate = TrainState.create(other.module, other.optimizer)
    for _ in range(2):
        ostate, om = ostep(ostate, {k: v[:2] for k, v in micro.items()},
                           weights[:2], 0)
    assert float(om["train_loss"]) == float(tm["train_loss"])
    for a, b in zip(other.module.parameters(), pair.module.parameters()):
        assert torch.equal(a, b)


def test_eval_step_matches_jax(pair):
    batch = dict(_batch(3, seed=4, rows=4))
    # teach row 0's argmax nothing: random weights give acc 0 everywhere,
    # so also check a row whose targets are all pad (auto-pass)
    batch["decoder_input_ids"] = batch["decoder_input_ids"].copy()
    batch["decoder_input_ids"][1, 1:] = 0
    jout = jax_step.make_eval_step(pair.jmodule, pair.jcfg, 0)(
        pair.params, {k: jnp.asarray(v) for k, v in batch.items()})
    tout = make_eval_step(pair.module, pair.cfg, 0, device="cpu")(batch)
    assert set(tout) == set(jout) == {"example_mask", "indices", "loss",
                                      "acc"}
    np.testing.assert_allclose(tout["loss"].numpy(), np.asarray(jout["loss"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tout["acc"].numpy(),
                                  np.asarray(jout["acc"]))
    np.testing.assert_array_equal(tout["indices"].numpy(),
                                  np.asarray(jout["indices"]))
    assert tout["acc"][1] == 1.0 and not pair.module.training


def test_entry_points_default_to_the_card(pair):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    for make in (make_train_step, make_accum_train_step):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(pair.module, pair.cfg, pair.optimizer, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(pair.module, pair.cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(pair.module,
                       dataclasses.replace(pair.cfg, template_based=True), 0)


def test_train_step_dropout_is_reproducible_from_the_seed():
    """p = 0.1: the same (seed, step) gives the same loss, another seed
    another, and eval mode is untouched by any of it."""
    def run(seed):
        pair = Pair()
        for m in pair.module.modules():
            if hasattr(m, "config"):
                m.config = m.config.replace(hidden_dropout_prob=0.1,
                                            attention_probs_dropout_prob=0.1)
        step = make_train_step(pair.module, pair.cfg, pair.optimizer, 0,
                               device="cpu")
        _, metrics = step(TrainState.create(pair.module, pair.optimizer),
                          pair.batch, seed)
        return float(metrics["total_loss"])
    a, b, c = run(7), run(7), run(8)
    assert a == b and a != c


# --- (g) learnability --------------------------------------------------------

def test_training_with_dropout_learns_a_toy_rule():
    """The role of tests/test_learning.py: with dropout 0.1 on, the decoder
    learns to name the class that the first encoder token carries. Chance
    is log(4) = 1.39 per class token; a run that learns reaches 0.2."""
    torch.manual_seed(0)
    enc, dec = _jax_configs()
    enc = TransformerConfig(**dataclasses.asdict(enc)).replace(
        hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    dec = TransformerConfig(**dataclasses.asdict(dec)).replace(
        hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    module = EncoderDecoder(enc, dec, dtype=torch.float32)
    from textreact_tpu_torch.models import init_weights
    init_weights(module, torch.Generator().manual_seed(0))
    cfg = ExperimentConfig(**dict(EXPERIMENT, mlm=False, lr=2e-3,
                                  warmup_ratio=0.0, scheduler="constant"))
    steps = 60
    optimizer = make_optimizer(cfg, steps, module.named_parameters())
    step = make_train_step(module, cfg, optimizer, 0, device="cpu")
    state = TrainState.create(module, optimizer)
    rng = np.random.default_rng(0)

    def batch(n=16):
        cls = rng.integers(0, 4, n)
        ids = rng.integers(10, ENC_V, (n, L)).astype(np.int32)
        ids[:, 0] = 5 + cls
        dec_ids = np.zeros((n, LD), np.int32)
        dec_ids[:, 0], dec_ids[:, 1], dec_ids[:, 2] = 1, 10 + cls, 2
        return {"input_ids": ids,
                "attention_mask": np.ones((n, L), np.int32),
                "decoder_input_ids": dec_ids,
                "decoder_attention_mask": (dec_ids > 0).astype(np.int32)}

    first = last = None
    for i in range(steps):
        state, metrics = step(state, batch(), seed=0)
        last = float(metrics["train_loss"])
        first = last if first is None else first
    assert first > 1.0
    assert last < 0.2, (first, last)
    held_out = batch(32)
    out = make_eval_step(module, cfg, 0, device="cpu")(
        dict(held_out, example_mask=np.ones(32, np.int32),
             indices=np.arange(32, dtype=np.int32)))
    assert float(out["acc"].mean()) >= 0.9
