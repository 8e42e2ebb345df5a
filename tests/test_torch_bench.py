"""The port's measurement tools (textreact_tpu_torch/bench.py and
bench_train.py) against the JAX package's (the root bench.py and
bench_train.py), on the CPU.

bench: the port's run at its CPU shape (exit 0, parity, the JAX line's four
keys and metric name), its data equal to the JAX tool's arrays, and the JAX
tool run beside it (the same keys, metric and N / d / k). bench_train: the
parameter count at full width equal to the JAX model's (the JAX count from
`jax.eval_shape`, the port's model built on the meta device); one step at
tiny widths, p = 0, f32, from `from_flax` weights, against the JAX
`make_train_step` on the same batch; a soak of a few seconds with the
cadences shortened; the soak's judgement of drift, builds and launches.
Both tools refuse to run without a card unless the CPU is asked for.
"""

import _torch_threads  # noqa: F401  (before torch runs)
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import textreact_tpu.config as jax_config
import textreact_tpu.train.optim as jax_optim
import textreact_tpu.train.step as jax_step
from textreact_tpu.models import BERT_L6_DECODER as JAX_BERT_L6_DECODER
from textreact_tpu.models import SCIBERT_BASE as JAX_SCIBERT_BASE
from textreact_tpu.models import EncoderDecoder as JaxEncoderDecoder
from textreact_tpu.models import TransformerConfig as JaxConfig
from textreact_tpu_torch import bench, bench_train
from textreact_tpu_torch.models import TransformerConfig, from_flax

ROOT = Path(__file__).resolve().parent.parent
KEYS = {"metric", "value", "unit", "vs_baseline"}
# f32 on both sides, values of order 1-10 that differ by summation order
# (tests/test_torch_train.py's tolerance)
RTOL, ATOL = 1e-5, 2e-5


def _run(argv, env=None, timeout=300):
    """(exit code, stdout lines) of a command run from the repo's root."""
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=dict(os.environ, **(env or {})))
    return proc.returncode, proc.stdout.strip().splitlines(), proc.stderr


def _shape(unit):
    """(N, d, k) from a retrieval line's unit."""
    m = re.search(r"N=(\d+), d=(\d+), k=(\d+)", unit)
    return tuple(int(x) for x in m.groups())


@pytest.fixture(scope="module")
def port_bench():
    return _run([sys.executable, "-m", "textreact_tpu_torch.bench",
                 "--device", "cpu"])


# --- bench ------------------------------------------------------------------

def test_bench_runs_on_the_cpu_with_parity_and_the_jax_line(port_bench):
    rc, lines, err = port_bench
    assert rc == 0, err
    assert any(line.startswith(f"parity: {bench.PARITY_QUERIES} queries "
                               "equal numpy_reference_topk")
               for line in lines)
    assert any(line.startswith("layout query-outer: end to end")
               for line in lines)
    record = json.loads(lines[-1])
    assert set(record) == KEYS
    assert record["metric"] == "retrieval_qps_exact_top20"
    assert record["value"] > 0 and record["vs_baseline"] > 0
    assert _shape(record["unit"]) == (20_000, 256, 20)
    assert "cpu corpus-split" in record["unit"]
    assert "device-only" not in record["unit"]   # no device on the CPU


@pytest.mark.parametrize("n,d,m", [(300, 64, 10), (20_000, 256, 128)])
def test_bench_data_equals_the_jax_tools_arrays(n, d, m):
    # bench.py:89-91, restated
    rng = np.random.default_rng(0)
    corpus = (rng.random((n, d)) < 0.08).astype(np.int8)
    queries = (rng.random((m, d)) < 0.08).astype(np.int8)
    got_corpus, got_queries = bench.make_data(n, d, m)
    assert got_corpus.dtype == got_queries.dtype == np.int8
    np.testing.assert_array_equal(got_corpus, corpus)
    np.testing.assert_array_equal(got_queries, queries)


def test_jax_bench_prints_the_same_line_shape(port_bench):
    rc, lines, err = _run([sys.executable, "bench.py"],
                          env={"JAX_PLATFORMS": "cpu"})
    assert rc == 0, err
    jax_record = json.loads(lines[-1])
    port_record = json.loads(port_bench[1][-1])
    assert set(jax_record) == set(port_record) == KEYS
    assert jax_record["metric"] == port_record["metric"]
    assert _shape(jax_record["unit"]) == _shape(port_record["unit"])


def test_bench_watchdog_prints_the_line_and_fails():
    rc, lines, _ = _run([sys.executable, "-m", "textreact_tpu_torch.bench",
                         "--device", "cpu"],
                        env={"BENCH_TIMEOUT": "1"})
    assert rc != 0
    record = json.loads(lines[-1])
    assert record["value"] is None and record["degraded"] == "hang_watchdog_1s"


@pytest.mark.parametrize("module", ["textreact_tpu_torch.bench",
                                    "textreact_tpu_torch.bench_train"])
def test_tools_fail_without_a_card(module):
    rc, lines, err = _run([sys.executable, "-m", module],
                          env={"CUDA_VISIBLE_DEVICES": ""}, timeout=120)
    assert rc != 0
    assert "no CUDA device" in err
    if module.endswith(".bench"):   # the line keeps its shape, rc fails
        record = json.loads(lines[-1])
        assert record["value"] is None
        assert record["degraded"] == "runtime_failure: RuntimeError"


# --- bench_train ------------------------------------------------------------

def test_bench_train_parameter_count_equals_jax():
    ln = "fused"
    jmodule = JaxEncoderDecoder(
        encoder_config=JAX_SCIBERT_BASE.replace(attention_impl="flash",
                                                layernorm_impl=ln),
        decoder_config=JAX_BERT_L6_DECODER.replace(
            vocab_size=315, attention_impl="flash", layernorm_impl=ln),
        dtype=jnp.bfloat16, mlm_layer="mlp")
    batch = {k: jnp.asarray(v) for k, v in bench_train.make_batch(1).items()}
    shapes = jax.eval_shape(lambda b: jmodule.init(
        jax.random.PRNGKey(0), input_ids=b["input_ids"],
        attention_mask=b["attention_mask"],
        decoder_input_ids=b["decoder_input_ids"],
        decoder_attention_mask=b["decoder_attention_mask"],
        mlm_prefix_len=64), batch)
    jax_count = sum(x.size for x in jax.tree.leaves(shapes))
    with torch.device("meta"):
        module = bench_train.build_module(*bench_train.model_configs(ln))
    assert bench_train.param_count(module) == jax_count


# tiny widths, both dropouts 0, the kernels' flags as the tools set them
TINY_L, TINY_LD, TINY_MLM, ENC_V, DEC_V = 128, 16, 16, 64, 40


def _tiny_jax_configs():
    enc = JaxConfig(vocab_size=ENC_V, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=256,
                    max_position_embeddings=TINY_L, type_vocab_size=2,
                    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                    attention_impl="flash", layernorm_impl="fused")
    dec = enc.replace(vocab_size=DEC_V, max_position_embeddings=32,
                      type_vocab_size=1, is_decoder=True,
                      add_cross_attention=True, bos_token_id=12,
                      eos_token_id=13, pad_token_id=0)
    return enc, dec


def _tiny_port_configs(layernorm_impl="fused"):
    return tuple(TransformerConfig(**dataclasses.asdict(c)).replace(
        layernorm_impl=layernorm_impl) for c in _tiny_jax_configs())


def test_bench_train_step_matches_jax():
    batch = bench_train.make_batch(2, TINY_L, TINY_LD, TINY_MLM, ENC_V,
                                   DEC_V)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jenc, jdec = _tiny_jax_configs()
    jmodule = JaxEncoderDecoder(encoder_config=jenc, decoder_config=jdec,
                                dtype=jnp.float32, mlm_layer="mlp")
    params = jmodule.init(
        jax.random.PRNGKey(0), input_ids=jbatch["input_ids"],
        attention_mask=jbatch["attention_mask"],
        decoder_input_ids=jbatch["decoder_input_ids"],
        decoder_attention_mask=jbatch["decoder_attention_mask"],
        mlm_prefix_len=TINY_MLM)
    # the JAX step donates its state: convert the weights first
    module = bench_train.build_module(*_tiny_port_configs(),
                                      dtype=torch.float32)
    module.load_state_dict(from_flax(jax.device_get(params)))
    jcfg = jax_config.ExperimentConfig(task="condition", mlm=True,
                                       mlm_lambda=0.1,
                                       compute_dtype="float32",
                                       mlm_impl="fused")
    tx = jax_optim.make_optimizer(jcfg, num_training_steps=1000)
    jstep = jax_step.make_train_step(jmodule, jcfg, tx, dec_pad_id=0)
    _, jm = jstep(jax_step.TrainState.create(params, tx), jbatch,
                  jax.random.key(1, impl=jcfg.dropout_rng_impl))

    cfg = bench_train.experiment("fused", compute_dtype="float32")
    state, step = bench_train.trainer(module, cfg, "cpu")
    state, tm = step(state, batch, bench_train.SEED)
    assert state.step == 1
    assert set(tm) == set(jm) == {"train_loss", "mlm_loss", "total_loss",
                                  "grad_norm"}
    for key in tm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)


@pytest.fixture
def tiny_bench(monkeypatch):
    """bench_train at tiny widths with the soak's cadences cut to a few
    seconds."""
    monkeypatch.setattr(bench_train, "model_configs", _tiny_port_configs)
    for name, value in (("ENC_LEN", TINY_L), ("MLM_LEN", TINY_MLM),
                        ("ENC_VOCAB", ENC_V), ("DEC_VOCAB", DEC_V),
                        ("WINDOW", 3), ("EVAL_EVERY_S", 0.5),
                        ("CKPT_EVERY_S", 1.0)):
        monkeypatch.setattr(bench_train, name, value)
    return bench_train


def test_bench_train_cpu_line(tiny_bench):
    lines = []
    record = tiny_bench.main(["--device", "cpu", "--batch_size", "2",
                              "--layernorm_impl", "xla"], log=lines.append)
    assert json.loads(lines[-1]) == record
    assert set(record) == KEYS
    assert record["metric"] == "train_examples_per_sec_rcr_flagship"
    assert record["value"] > 0
    assert "B=2, L=128" in record["unit"] and "ln=xla, mlm=fused, 1 CPU" in \
        record["unit"]
    assert "device span not measured" in lines[-2]


def test_soak_fires_eval_and_checkpoint_and_builds_nothing(tiny_bench):
    lines = []
    try:
        tiny_bench.main(["--device", "cpu", "--batch_size", "2", "--soak",
                         "0.05"], log=lines.append)
    except SystemExit as e:
        # the host's clock under the test's workers may move the step time
        # by more than the card's bound; nothing else may fail
        assert re.fullmatch(r"SOAK FAILED: drift=-?[\d.]+% \(\|limit\| 2%\)",
                            str(e)), e
    record = json.loads(lines[-1])
    assert set(record) == KEYS and record["metric"] == "train_soak_flagship"
    unit = record["unit"]
    evals = int(re.search(r"evals=(\d+)", unit).group(1))
    ckpts = int(re.search(r"ckpts=(\d+)", unit).group(1))
    windows = int(re.search(r"(\d+) windows x 3 steps", unit).group(1))
    assert evals >= 1 and ckpts >= 1 and windows >= 2
    assert "kernel_builds=0" in unit and "hbm_peak=n/a" in unit
    assert re.search(r"cpu_drift=-?[\d.]+%", unit)
    assert all(line.startswith("  window ") for line in lines[:-1])


LAUNCHES = {"attention_fwd": 12, "layernorm_fwd": 42}


@pytest.mark.parametrize("windows,builds,launches,failed", [
    ([1.3, 1.00, 1.01, 1.00, 1.019, 1.02, 1.019], [], [LAUNCHES] * 7, []),
    ([1.3, 1.00, 1.01, 1.00, 1.03, 1.03, 1.021], [], [LAUNCHES] * 7,
     ["drift"]),
    ([1.3, 1.00, 1.01, 1.00, 0.979, 0.97, 0.979], [], [LAUNCHES] * 7,
     ["drift"]),
    ([1.3, 1.00, 1.00], [("fused_layernorm", 2.0)], [LAUNCHES] * 3,
     ["builds"]),
    ([1.3, 1.00, 1.00], [], [LAUNCHES, LAUNCHES,
                             dict(LAUNCHES, layernorm_fwd=43)],
     ["launches"]),
    ([1.3], [], [LAUNCHES], ["windows"]),
])
def test_soak_judgement(windows, builds, launches, failed):
    problems, drift, last = bench_train.judge(windows, builds, launches)
    assert sorted(problems) == failed
    if len(windows) > 1:
        assert last == min(windows[1:][-3:])
        assert drift == pytest.approx(last / min(windows[1:4]) - 1)
        assert (drift, last) == bench_train.step_drift(windows)
