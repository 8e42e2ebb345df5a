"""The program's named spans (textreact_tpu_torch/utils/profiling.py
`span`), on the CPU at a tiny size.

With no profiler running, a served batch and an accumulated train step
open no `record_function` range at all. Under `torch.profiler.profile`
they give the span tree of the serving, train and eval steps: one
`serve.prologue` a batch, one `serve.step` a decode step the card ran
(`Generator.last_replays`), the decode's parts once a step and layer, one
`train.micro` a real micro-batch and one `train.update` a step. The gate
is the profiler's own flag, and follows it across sessions.

One test needs a GPU (the `cuda` marker; it skips from a fixture without
one): a CUDA graph's replayed kernels are put down to `serve.step` through
their `cudaGraphLaunch`'s correlation id.
"""

import _torch_threads  # noqa: F401  (before torch runs)
import dataclasses
import json
from collections import Counter

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import spans as portbench_spans
from textreact_tpu_torch.config import ExperimentConfig
from textreact_tpu_torch.inference import Generator
from textreact_tpu_torch.models import EncoderDecoder, TransformerConfig
from textreact_tpu_torch.train import (TrainState, make_accum_train_step,
                                       make_eval_step, make_optimizer,
                                       make_train_step)
from textreact_tpu_torch.utils import profiling
from textreact_tpu_torch.utils.profiling import SPANS, span

LAYERS = 2
BEAMS, DEC_LEN = 3, 8
WEIGHTS = np.array([1.0, 1.0, 0.0], np.float32)   # two real micro-batches


def _module(device="cpu", seed=0) -> EncoderDecoder:
    torch.manual_seed(seed)
    enc = TransformerConfig(vocab_size=32, hidden_size=64,
                            num_hidden_layers=1, num_attention_heads=2,
                            intermediate_size=128,
                            max_position_embeddings=32)
    dec = dataclasses.replace(enc, num_hidden_layers=LAYERS, is_decoder=True,
                              add_cross_attention=True, bos_token_id=1,
                              eos_token_id=2, pad_token_id=0)
    return EncoderDecoder(enc, dec, dtype=torch.float32).to(device)


def _serve_batch(B=2, L=16):
    rng = np.random.default_rng(0)
    return {"input_ids": rng.integers(3, 32, (B, L)).astype(np.int32),
            "attention_mask": np.ones((B, L), np.int32)}


def _train_batch(B=2, L=16, Ld=6, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(3, 32, (B, L)).astype(np.int32),
            "attention_mask": np.ones((B, L), np.int32),
            "decoder_input_ids": rng.integers(3, 32, (B, Ld)).astype(np.int32),
            "decoder_attention_mask": np.ones((B, Ld), np.int32),
            "example_mask": np.ones((B,), bool),
            "indices": np.arange(B, dtype=np.int32)}


def _accum_step(module):
    cfg = ExperimentConfig(lr=1e-3, scheduler="constant")
    opt = make_optimizer(cfg, 10, module.named_parameters())
    step = make_accum_train_step(module, cfg, opt, 0, device="cpu")
    micro = [_train_batch(seed=s) for s in (1, 2, 2)]
    arrays = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    return step, TrainState.create(module, opt), arrays


def _names(prof) -> Counter:
    return Counter(ev.name for ev in prof.events() if ev.name in SPANS)


def test_no_profiler_enters_no_range(monkeypatch):
    """A served batch, an accumulated train step and an eval step, with no
    profiler running: no `record_function` range is entered."""
    def refuse(self):
        raise AssertionError(f"record_function({self.name!r}) entered")

    monkeypatch.setattr(record_function, "__enter__", refuse)
    module = _module()
    Generator(module, BEAMS, DEC_LEN).generate(_serve_batch())
    step, state, arrays = _accum_step(module)
    step(state, arrays, WEIGHTS, 0)
    make_eval_step(module, ExperimentConfig(), 0, device="cpu")(
        _train_batch())
    assert span("serve.batch") is span("train.step")   # the shared null


def test_gate_follows_the_profiler_across_sessions():
    """The gate is the profiler's module flag, read at each call: off,
    on inside each of two sessions, off after each."""
    assert isinstance(autograd_profiler._is_profiler_enabled, bool)
    assert profiling.autograd_profiler is autograd_profiler
    for _ in range(2):
        assert not isinstance(span("serve.batch"), record_function)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert autograd_profiler._is_profiler_enabled
            with span("serve.batch"):
                pass
        assert not autograd_profiler._is_profiler_enabled
        assert _names(prof) == {"serve.batch": 1}
    assert not isinstance(span("serve.batch"), record_function)


def test_a_served_batch_gives_its_span_tree():
    gen = Generator(_module(), BEAMS, DEC_LEN)
    gen.generate(_serve_batch())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gen.generate(_serve_batch())
    steps = gen.last_replays
    assert steps > 0
    assert _names(prof) == {
        "serve.batch": 1, "serve.stage": 1, "serve.prologue": 1,
        "serve.step": steps, "serve.stop_read": steps,
        "serve.finalize": 1, "serve.readback": 1,
        "beam.ancestor_bias": steps,
        "decode.self_attention": steps * LAYERS,
        "decode.cross_attention": steps * LAYERS,
        # two products in each attention
        "decode.products": 4 * steps * LAYERS,
        # the one encoder layer's attention (attention_impl "xla")
        "attention.plain": 1}


def test_a_train_step_gives_its_span_tree():
    """An accumulated step of two real micro-batches and a pad, a one-batch
    step, and an eval step."""
    module = _module()
    step, state, arrays = _accum_step(module)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, arrays, WEIGHTS, 0)
    # the plain attention path (attention_impl "xla"): the encoder's layer,
    # and each decoder layer's self- and cross-attention, a micro-batch
    plain = 1 + 2 * LAYERS
    assert _names(prof) == {"train.step": 1, "train.stage": 2,
                            "train.micro": 2, "train.update": 1,
                            "attention.plain": 2 * plain}
    cfg = ExperimentConfig(lr=1e-3, scheduler="constant")
    single = make_train_step(module, cfg, step.optimizer, 0, device="cpu")
    evaluate = make_eval_step(module, cfg, 0, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        single(state, _train_batch(), 0)
        evaluate(_train_batch())
    assert _names(prof) == {"train.step": 1, "train.stage": 1,
                            "train.micro": 1, "train.update": 1,
                            "eval.forward": 1, "attention.plain": 2 * plain}


def test_spans_nest_where_the_table_puts_them():
    """Every serving span but the batch lies inside `serve.batch`, every
    train part inside `train.step`, the decode's parts inside a step."""
    gen = Generator(_module(), BEAMS, DEC_LEN)
    step, state, arrays = _accum_step(gen.module)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gen.generate(_serve_batch())
        step(state, arrays, WEIGHTS, 0)
    ranges = {}
    for ev in prof.events():
        if ev.name in SPANS:
            ranges.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))

    def within(inner, outer):
        return all(any(a <= x and y <= b for a, b in ranges[outer])
                   for x, y in ranges[inner])

    for name in ("serve.stage", "serve.prologue", "serve.step",
                 "serve.stop_read", "serve.finalize", "serve.readback"):
        assert within(name, "serve.batch"), name
    for name in ("beam.ancestor_bias", "decode.self_attention",
                 "decode.cross_attention", "decode.products"):
        assert within(name, "serve.step"), name
    for name in ("train.stage", "train.micro", "train.update"):
        assert within(name, "train.step"), name


TINY_JSON = {"vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 1,
             "num_attention_heads": 4, "intermediate_size": 64,
             "max_position_embeddings": 128, "type_vocab_size": 1}


def test_the_trainers_profile_holds_the_loop_spans(tmp_path):
    """`Trainer.fit` under `--profile`: the trace.json it writes holds a
    `train.loader_wait` a loader batch taken (and the one that ends the
    epoch), a `train.step` an optimizer step, an `eval.forward` a
    validation batch."""
    from fixtures import make_condition_data
    from textreact_tpu_torch.train.trainer import Trainer
    root = make_condition_data(str(tmp_path))
    for name, vocab in (("enc", 64), ("dec", 320)):
        with open(f"{root}/{name}.json", "w") as f:
            json.dump(dict(TINY_JSON, vocab_size=vocab), f)
    cfg = ExperimentConfig(
        task="condition", data_path=root, train_file="train.csv",
        valid_file="val.csv", corpus_file=f"{root}/corpus.csv",
        nn_path=root, train_nn_file="train_nn.json",
        valid_nn_file="val_nn.json",
        text_vocab_file=f"{root}/text_vocab.txt",
        encoder=f"{root}/enc.json", decoder=f"{root}/dec.json",
        encoder_tokenizer="text", num_neighbors=2, use_gold_neighbor=True,
        max_length=64, max_dec_length=16, batch_size=8, test_batch_size=8,
        epochs=1, length_buckets=(64,), dec_length_buckets=(16,),
        compute_dtype="float32", do_train=True, profile=True,
        save_path=str(tmp_path / "run"))
    trainer = Trainer(cfg, device="cpu")
    trainer.prepare_data()
    trainer.fit()
    with open(tmp_path / "run" / "profile" / "trace.json") as f:
        names = Counter(e["name"] for e in json.load(f)["traceEvents"]
                        if e.get("cat") == "user_annotation")
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        steps = max(json.loads(line).get("step", 0) for line in f)
    assert steps > 0
    assert names["train.step"] == steps
    assert names["train.loader_wait"] == steps + 1
    assert names["train.micro"] == names["train.update"] == steps
    assert names["eval.forward"] > 0


def _card_trace(fn, path):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    return out, json.loads(path.read_text())["traceEvents"]


@pytest.mark.cuda
def test_a_replay_is_put_down_to_its_span_on_the_card(tmp_path):
    """On the card: the first batch, which captures the prologue and the
    step under the profiler, gives the same beams as the uncaptured loop;
    the second, a replay, traced: its decode steps' kernels carry their
    `cudaGraphLaunch`'s correlation id and land under `serve.step`, and
    every kernel and copy falls under a span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs have no CPU mode")
    gen = Generator(_module("cuda"), BEAMS, DEC_LEN)
    assert gen.route == "cuda_graphs"
    batch = _serve_batch(B=4, L=32)
    (seqs, scores), events = _card_trace(lambda: gen.generate(batch),
                                         tmp_path / "trace.capture.json")
    assert portbench_spans.Spans(events).count["graph.capture"] == 2
    ref = Generator(gen.module, BEAMS, DEC_LEN)
    ref.route = "uncaptured"
    want_seqs, want_scores = ref.generate(batch)
    np.testing.assert_array_equal(seqs, want_seqs)
    np.testing.assert_array_equal(scores, want_scores)
    _, events = _card_trace(lambda: gen.generate(batch),
                            tmp_path / "trace.replay.json")
    got = portbench_spans.Spans(events)
    assert got.count["serve.step"] == gen.last_replays
    assert got.count["serve.prologue"] == 1
    assert "graph.capture" not in got.count
    launches = {e["args"]["correlation"] for e in events
                if e.get("name") == "cudaGraphLaunch"}
    replayed = [e for e in events if e.get("cat") == "kernel"
                and e["args"].get("correlation") in launches]
    assert replayed
    assert got.device_us["serve.step"] > 0
    assert got.device_us["serve.prologue"] > 0
    assert got.unattributed_us == 0.0
