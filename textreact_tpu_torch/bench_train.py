"""Training benchmark: the flagship model's train step on one card (twin of
the repo's root bench_train.py).

    python -m textreact_tpu_torch.bench_train [--batch_size 32]
        [--layernorm_impl {xla,fused}] [--mlm_impl {fused,xla}]
        [--soak MINUTES] [--device cpu]

RCR geometry, as the JAX tool: a SciBERT-base encoder and a bert_l6 decoder
(vocab 315), both with the attention and LayerNorm kernels selected as the
flags say, bf16 compute over f32 parameters, the MLM head (mlp) on a prefix
of 64 positions; a batch of B x 512 encoder and B x 16 decoder tokens drawn
from numpy's default_rng(0) in the JAX tool's order; AdamW over a
1000-step schedule; `train.step.make_train_step` with one dropout seed (the
step reseeds its masks from it and the step count). Weights are random,
drawn from a seeded torch.Generator.

One warm step, then 10 steps and one host readback of the loss: the last
line is ONE JSON object (metric, value in examples/s, unit, vs_baseline).
The earlier lines give the device span of the same 10 steps (CUDA events)
and each kernel's launches per step.

`--soak MINUTES` trains for that long in windows of WINDOW steps with one
readback each, an eval forward (the f32 sum of the word embeddings) every
EVAL_EVERY_S seconds and a checkpoint save ("last", the background write
of train/checkpoint.py) every CKPT_EVERY_S seconds, and fails (SystemExit)
unless the step time drifts by less than DRIFT_LIMIT (the best of the first
three steady windows against the best of the last three), no kernel is
built after the warm step and every window launches each kernel the same
number of times. It reports the peak device memory, the caching
allocator's retries, and `cpu_drift`: the same drift of the CPU time of the
thread that issues the step (where the step is host-bound, the host's speed
moves both drifts together).

Both records name the train step's route in their unit (`route=`): on the
card "cuda_graphs", the micro-batch part and the update replayed as CUDA
graphs (train/graphs.py); elsewhere "uncaptured".

Runs on the CUDA card unless `--device cpu` is given; without a card it
fails.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import ExperimentConfig
from .models import EncoderDecoder, init_weights
from .models.config import BERT_L6_DECODER, SCIBERT_BASE, TransformerConfig
from .models.factory import check_kernel_shapes, resolve_device
from .ops import _build, fused_attention, fused_layernorm, topk
from .train import TrainState, make_optimizer, make_train_step
from .train.checkpoint import CheckpointManager
from .train.step import to_device

METRIC = "train_examples_per_sec_rcr_flagship"
SOAK_METRIC = "train_soak_flagship"
ENC_LEN, DEC_LEN, MLM_LEN = 512, 16, 64
ENC_VOCAB, DEC_VOCAB = 31000, 315    # the batch draws ids in [1, vocab)
MLM_LAYER = "mlp"
SEED = 1                  # the dropout seed of every step
NUM_TRAINING_STEPS = 1000
REPS = 10
# --soak
WINDOW = 50
EVAL_EVERY_S, CKPT_EVERY_S = 120.0, 300.0
DRIFT_LIMIT = 0.02


def model_configs(layernorm_impl: str
                  ) -> Tuple[TransformerConfig, TransformerConfig]:
    """(encoder, decoder) configs of the flagship at full width."""
    return (SCIBERT_BASE.replace(attention_impl="flash",
                                 layernorm_impl=layernorm_impl),
            BERT_L6_DECODER.replace(vocab_size=DEC_VOCAB,
                                    attention_impl="flash",
                                    layernorm_impl=layernorm_impl))


def build_module(enc: TransformerConfig, dec: TransformerConfig,
                 dtype: torch.dtype = torch.bfloat16) -> EncoderDecoder:
    """The flagship module, its weights not drawn (build it under
    `torch.device("meta")` to count parameters)."""
    return EncoderDecoder(enc, dec, dtype=dtype, mlm_layer=MLM_LAYER)


def param_count(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def experiment(mlm_impl: str, compute_dtype: str = "bfloat16"
               ) -> ExperimentConfig:
    return ExperimentConfig(task="condition", mlm=True, mlm_lambda=0.1,
                            compute_dtype=compute_dtype, mlm_impl=mlm_impl)


def make_batch(batch_size: int, enc_len: int = ENC_LEN,
               dec_len: int = DEC_LEN, mlm_len: int = MLM_LEN,
               enc_vocab: int = ENC_VOCAB, dec_vocab: int = DEC_VOCAB,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX tool's batch: the same keys, dtypes and draws in its order
    (encoder ids, decoder ids, MLM labels)."""
    rng = np.random.default_rng(seed)
    B = batch_size
    return {
        "input_ids": rng.integers(1, enc_vocab, (B, enc_len)).astype(np.int32),
        "attention_mask": np.ones((B, enc_len), np.int32),
        "position_ids": np.tile(np.arange(enc_len, dtype=np.int32)[None],
                                (B, 1)),
        "decoder_input_ids": rng.integers(1, dec_vocab, (B, dec_len)
                                          ).astype(np.int32),
        "decoder_attention_mask": np.ones((B, dec_len), np.int32),
        "mlm_labels": rng.integers(1, enc_vocab, (B, mlm_len)
                                   ).astype(np.int32),
        "example_mask": np.ones((B,), np.int32),
        "indices": np.arange(B, dtype=np.int32),
    }


def trainer(module: torch.nn.Module, cfg: ExperimentConfig, device):
    """(TrainState, train_step) of `module` under `cfg`."""
    optimizer = make_optimizer(cfg, NUM_TRAINING_STEPS,
                               module.named_parameters())
    state = TrainState.create(module, optimizer)
    return state, make_train_step(module, cfg, optimizer, dec_pad_id=0,
                                  device=device)


def launches() -> Dict[str, int]:
    """The kernels' launch counters."""
    return {"attention_fwd": fused_attention.LAUNCHES,
            "attention_bwd": fused_attention.BWD_LAUNCHES,
            "causal_attention_fwd": fused_attention.CAUSAL_LAUNCHES,
            "causal_attention_bwd": fused_attention.CAUSAL_BWD_LAUNCHES,
            "layernorm_fwd": fused_layernorm.LAUNCHES,
            "layernorm_bwd": fused_layernorm.BWD_LAUNCHES,
            "topk": sum(topk.LAUNCHES.values())}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in launches().items()}


def _nonzero(counts: Dict[str, float]) -> Dict[str, float]:
    return {k: v for k, v in counts.items() if v}


class Bench:
    """The module, its train step and the batch, on one device."""

    def __init__(self, batch_size: int = 32, layernorm_impl: str = "fused",
                 mlm_impl: str = "fused", device=None):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.layernorm_impl, self.mlm_impl = layernorm_impl, mlm_impl
        enc, dec = model_configs(layernorm_impl)
        if self.device.type == "cuda":
            check_kernel_shapes(enc)
            check_kernel_shapes(dec, attention=False)
        self.module = build_module(enc, dec)
        init_weights(self.module, torch.Generator().manual_seed(0))
        self.module.to(self.device)
        self.n_params = param_count(self.module)
        self.cfg = experiment(mlm_impl)
        self.state, self.step = trainer(self.module, self.cfg, self.device)
        self.batch = to_device(make_batch(batch_size, ENC_LEN, DEC_LEN,
                                          MLM_LEN, ENC_VOCAB, DEC_VOCAB),
                               self.device)

    def train(self, steps: int) -> torch.Tensor:
        """Queue `steps` train steps; the last step's loss, on the device."""
        for _ in range(steps):
            self.state, metrics = self.step(self.state, self.batch, SEED)
        return metrics["train_loss"]

    def _events(self):
        if self.device.type != "cuda":
            return None
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def throughput(self) -> dict:
        """One warm step, then REPS steps and one readback: examples/s (host
        clock), the device span of the REPS steps (CUDA events; None on the
        CPU) and each kernel's launches per step."""
        float(self.train(1))
        before = launches()
        events = self._events()
        t0 = time.perf_counter()
        if events:
            events[0].record()
        loss = self.train(REPS)
        if events:
            events[1].record()
        loss = float(loss)                # host readback: all steps done
        dt = (time.perf_counter() - t0) / REPS
        per_step = {k: v / REPS for k, v in _since(before).items()}
        device_ms = (events[0].elapsed_time(events[1]) / REPS if events
                     else None)
        return dict(examples_per_s=self.batch_size / dt, step_ms=dt * 1e3,
                    device_ms=device_ms, launches_per_step=per_step,
                    loss=loss, record=self.record(dt))

    def describe(self) -> str:
        where = "1 GPU" if self.device.type == "cuda" else "1 CPU"
        return (f"B={self.batch_size}, L={ENC_LEN}, "
                f"params={self.n_params / 1e6:.1f}M, bf16+fused, "
                f"ln={self.layernorm_impl}, mlm={self.mlm_impl}, {where}, "
                f"route={self.step.route}")

    def record(self, dt: float) -> dict:
        return {"metric": METRIC, "value": round(self.batch_size / dt, 1),
                "unit": f"examples/s ({self.describe()})",
                "vs_baseline": None}

    def embedding_sum(self) -> float:
        """The soak's eval forward: the f32 sum of the word embeddings."""
        with torch.no_grad():
            weight = self.module.encoder.embeddings.word_embeddings.weight
            return float(weight.float().sum())

    def soak(self, minutes: float, log=print
             ) -> Tuple[dict, Dict[str, str]]:
        """Train for `minutes` (see the module's docstring); returns the
        JSON record and the failed checks by name (`judge`; empty:
        passed). Each window also reads the CPU time of this thread (it
        issues the step: its kernels, or its graphs' replays) and, on the
        card, the caching allocator's retries."""
        float(self.train(1))
        builds = dict(_build.BUILD_SECONDS)
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.device)
        windows: List[float] = []
        cpu: List[float] = []
        window_launches: List[Dict[str, int]] = []
        evals = ckpts = retries = 0
        next_eval, next_ckpt = EVAL_EVERY_S, CKPT_EVERY_S
        with tempfile.TemporaryDirectory(prefix="soak_ckpt_") as ckpt_dir:
            mgr = CheckpointManager(ckpt_dir, "val_acc")
            t_start = time.perf_counter()
            while time.perf_counter() - t_start < minutes * 60:
                before = launches()
                r0 = _alloc_retries(self.device)
                t0, c0 = time.perf_counter(), time.thread_time()
                loss = float(self.train(WINDOW))
                dt = (time.perf_counter() - t0) / WINDOW
                cpu.append((time.thread_time() - c0) / WINDOW)
                windows.append(dt)
                window_launches.append(_since(before))
                retries += _alloc_retries(self.device) - r0
                elapsed = time.perf_counter() - t_start
                if elapsed >= next_eval:
                    self.embedding_sum()
                    evals += 1
                    next_eval += EVAL_EVERY_S
                if elapsed >= next_ckpt:
                    mgr.save("last", self.state, {"step": len(windows)})
                    ckpts += 1
                    next_ckpt += CKPT_EVERY_S
                log(f"  window {len(windows):3d}: {dt * 1e3:6.2f} ms/step "
                    f"({self.batch_size / dt:6.1f} ex/s) loss {loss:.4f}, "
                    f"this thread's CPU {cpu[-1] * 1e3:6.2f} ms/step")
            mgr.finalize()
        new_builds = sorted(set(_build.BUILD_SECONDS.items())
                            - set(builds.items()))
        problems, drift, last = judge(windows, new_builds, window_launches)
        peak = torch.cuda.max_memory_allocated(self.device) if on_card \
            else "n/a"
        record = {
            "metric": SOAK_METRIC,
            "value": round(self.batch_size / last, 1),
            "unit": (f"examples/s final ({self.describe()}, {len(windows)} "
                     f"windows x {WINDOW} steps, {minutes:g} min, "
                     f"evals={evals}, ckpts={ckpts}, "
                     f"drift={drift * 100:.2f}%, "
                     f"cpu_drift={step_drift(cpu)[0] * 100:.2f}%, "
                     f"kernel_builds={len(new_builds)}, "
                     f"launches_per_window="
                     f"{_nonzero(window_launches[0]) if windows else None}, "
                     f"alloc_retries={retries if on_card else 'n/a'}, "
                     f"hbm_peak={peak})"),
            "vs_baseline": None,
        }
        return record, problems


def _alloc_retries(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return torch.cuda.memory_stats(device).get("num_alloc_retries", 0)


def step_drift(times: List[float]) -> Tuple[float, float]:
    """(drift, last): `last`, the best of the last three steady windows'
    times, against the best of the first three, as a fraction (window 0 may
    hold the end of the warm-up); NaN with fewer than two windows."""
    steady = times[1:]
    if not steady:
        return float("nan"), float("nan")
    first, last = min(steady[:3]), min(steady[-3:])
    return (last - first) / first, last


def judge(windows: List[float], new_builds: list,
          window_launches: List[Dict[str, int]]
          ) -> Tuple[Dict[str, str], float, float]:
    """(failed checks by name, drift, last) of a soak: "drift", the step
    time's `step_drift`, not within DRIFT_LIMIT; "builds", a kernel built
    after the warm step; "launches", windows that launch the kernels
    differently; "windows", fewer than two windows to judge."""
    drift, last = step_drift(windows)
    problems = {}
    if len(windows) < 2:
        problems["windows"] = f"{len(windows)} windows: too short to judge"
    elif not abs(drift) < DRIFT_LIMIT:
        problems["drift"] = (f"drift={drift * 100:.2f}% (|limit| "
                             f"{DRIFT_LIMIT * 100:g}%)")
    if new_builds:
        problems["builds"] = f"kernels built after the warm step: {new_builds}"
    if any(w != window_launches[0] for w in window_launches):
        problems["launches"] = (f"launches differ between windows: "
                                f"{window_launches}")
    return problems, drift, last


def main(argv: Optional[list] = None, log=print) -> dict:
    """Runs the benchmark and prints its lines; returns the JSON record
    (and raises SystemExit when a soak fails)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layernorm_impl", default="fused",
                    choices=["xla", "fused"],
                    help="A/B the fused residual+dropout+LN kernel")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--mlm_impl", default="fused", choices=["fused", "xla"],
                    help="A/B the fused MLM linear+CE fold")
    ap.add_argument("--soak", type=float, default=0.0, metavar="MINUTES",
                    help="sustained run: train for MINUTES with the eval and "
                         "checkpoint cadence; reports step-time drift, "
                         "kernel builds and the peak device memory")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    bench = Bench(args.batch_size, args.layernorm_impl, args.mlm_impl,
                  args.device)
    if bench.device.type == "cuda":
        log(f"device: {torch.cuda.get_device_name(bench.device)}")
    if args.soak:
        record, problems = bench.soak(args.soak, log=log)
        log(json.dumps(record))
        if problems:
            raise SystemExit("SOAK FAILED: " + "; ".join(problems.values()))
        return record
    result = bench.throughput()
    log(f"{result['step_ms']:.2f} ms a step (host clock), device span "
        + (f"{result['device_ms']:.2f} ms a step (CUDA events)"
           if result["device_ms"] is not None else "not measured")
        + f", loss {result['loss']:.4f}; kernel launches per step "
        f"{_nonzero(result['launches_per_step'])}")
    log(json.dumps(result["record"]))
    return result["record"]


if __name__ == "__main__":
    main()
