#!/usr/bin/env python3
"""Drive the PyTorch port's RCR serving path once on one CUDA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build: compile every CUDA kernel of the path from textreact_tpu_torch/csrc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving path gives it, in float32 and bfloat16, with a
   stated tolerance, and both timed (CUDA events, median of 20 calls);
4. main path: the RCR recipe's serving configuration at full width
   (SciBERT-base encoder, 12 x 768, L=512, bf16; bert_l6 decoder, beam 15,
   16 decode positions; batch 32) with random weights from a seeded
   torch.Generator: tokenize 32 requests, Generator.generate,
   predictions_from_beams; checks shapes, finite non-increasing scores, and
   that the pass went through both kernels (launch counts);
5. the same batch's encoder states with the kernels and with the plain
   functions, within a stated bf16 bound.

Prints a JSON line of per-kernel results, then, as the last line,
{"ok": true, "device": {...}}. Exits non-zero without CUDA.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from textreact_tpu.config import ExperimentConfig
from textreact_tpu.tokenizers import get_tokenizers
from textreact_tpu_torch.inference import Generator, predictions_from_beams
from textreact_tpu_torch.models import build_model
from textreact_tpu_torch.ops import _build, fused_attention, fused_layernorm

# serving shapes: B=32 requests of L=512 tokens, 12 heads of 64; the
# encoder's LN rows are B*L, a decode step's are B*beams
B, L, HEADS, HEAD_DIM, HIDDEN, BEAMS, DEC_LEN = 32, 512, 12, 64, 768, 15, 16
BF16_ULP = 2.0 ** -7  # relative spacing of bf16 just above a power of two

# kernel vs plain, per dtype: (atol, rtol). f32: both sides compute in f32
# and differ by summation order only. bf16: same f32 math, but each side
# rounds its f32 result to bf16 (and the plain attention rounds the
# probabilities to bf16 before meeting v, as the TPU kernel does), so a
# result may land one bf16 ulp away
ATTN_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2e-2, 0.0)}
LN_TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (1.6e-2, BF16_ULP)}
# encoder output after 12 layers, kernels vs plain functions. bf16: the two
# paths round activations to bf16 at different places and the differences
# compound through the layers (LN outputs reach |x| ~ 4-8, where one bf16
# ulp is 2^-5..2^-4). f32: summation order only
ENCODER_BOUND = {"bfloat16": 0.125, "float32": 1e-3}

KERNELS = {
    "fused_attention": dict(
        route="cuda", source="textreact_tpu_torch/csrc/fused_attention.cu",
        replaces="textreact_tpu/ops/fused_attention.py:60"),
    "fused_layernorm": dict(
        route="cuda", source="textreact_tpu_torch/csrc/fused_layernorm.cu",
        replaces="textreact_tpu/ops/fused_layernorm.py:70"),
}

WORDS = ("the mixture was stirred at room temperature for 2 h then "
         "concentrated under reduced pressure and the residue purified by "
         "column chromatography on silica gel to give the title compound as "
         "a white solid yield 85 % a solution of in dichloromethane was "
         "added dropwise to triethylamine at 0 c and heated to reflux "
         "overnight water extracted with ethyl acetate dried over sodium "
         "sulfate filtered").split()
REACTIONS = ["CC(=O)Cl.OCc1ccccc1>>CC(=O)OCc1ccccc1",
             "Brc1ccccc1.OB(O)c1ccccc1>>c1ccc(-c2ccccc2)cc1",
             "CCOC(=O)C.NCCN>>CC(=O)NCCN",
             "O=C(O)c1ccccc1.CCO>>CCOC(=O)c1ccccc1"]


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20) -> float:
    """Median of `reps` single-call times in ms (CUDA events), after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of `reps` calls, each ended by a synchronize,
    after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor,
                atol: float, rtol: float) -> float:
    diff = (got.float() - ref.float()).abs()
    err = float(diff.max())
    excess = float((diff - atol - rtol * ref.float().abs()).max())
    log(f"  {name}: max_abs_err {err:.3e} (tolerance atol {atol:g} + "
        f"rtol {rtol:g} * |ref|)")
    if not excess <= 0.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    fused_attention.load_kernel()
    fused_layernorm.load_kernel()
    log(f"[build] both kernels loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc seconds per kernel: {_build.BUILD_SECONDS or 'cached'})")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_kernels(results: dict) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    lengths = rng.integers(64, L + 1, B)
    lengths[0] = L
    lengths[-1] = 0  # a collator dummy row: every key masked
    mask = torch.as_tensor(np.arange(L)[None, :] < lengths[:, None],
                           dtype=torch.int32, device=dev)
    scale = HEAD_DIM ** -0.5
    log(f"[kernels] attention B={B} L={L} H={HEADS} D={HEAD_DIM}, ragged "
        f"mask, row {B - 1} fully masked")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(B, L, HEADS, HEAD_DIM, generator=gen,
                               device=dev).to(dtype) for _ in range(3))
        got = fused_attention.fused_dropout_attention(q, k, v, mask, 0.0,
                                                      None, scale)
        ref = fused_attention.attention_reference(q, k, v, mask, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError("attention kernel output is not finite")
        err = check_close(f"attention {dtype}", got, ref, *ATTN_TOL[dtype])
        ms = time_ms(lambda: fused_attention.fused_dropout_attention(
            q, k, v, mask, 0.0, None, scale))
        plain_ms = time_ms(lambda: fused_attention.attention_reference(
            q, k, v, mask, scale))
        log(f"  attention {dtype}: kernel {ms:.4f} ms/call, plain "
            f"{plain_ms:.4f} ms/call")
        if dtype == torch.bfloat16:
            results["fused_attention"] = dict(max_abs_err=err, ms=ms,
                                              plain_ms=plain_ms)
    for rows in (B * L, B * BEAMS):
        log(f"[kernels] residual LayerNorm R={rows} H={HIDDEN}")
        for dtype in (torch.float32, torch.bfloat16):
            x, y = (torch.randn(rows, HIDDEN, generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            w = 1.0 + 0.1 * torch.randn(HIDDEN, generator=gen, device=dev)
            b = 0.1 * torch.randn(HIDDEN, generator=gen, device=dev)
            got = fused_layernorm.fused_residual_layernorm(x, y, w, b, 1e-5)
            ref = fused_layernorm.residual_layernorm_reference(x, y, w, b,
                                                               1e-5)
            torch.cuda.synchronize()
            err = check_close(f"layernorm R={rows} {dtype}", got, ref,
                              *LN_TOL[dtype])
            ms = time_ms(lambda: fused_layernorm.fused_residual_layernorm(
                x, y, w, b, 1e-5))
            plain_ms = time_ms(
                lambda: fused_layernorm.residual_layernorm_reference(
                    x, y, w, b, 1e-5))
            log(f"  layernorm R={rows} {dtype}: kernel {ms:.4f} ms/call, "
                f"plain {plain_ms:.4f} ms/call")
            if dtype == torch.bfloat16 and rows == B * L:
                results["fused_layernorm"] = dict(max_abs_err=err, ms=ms,
                                                  plain_ms=plain_ms)


def write_text_vocab(path: Path) -> None:
    """A WordPiece vocab (SciBERT's is not bundled): specials, the words
    above, and every printable character alone and as a continuation, so
    SMILES split into characters rather than [UNK]."""
    chars = [chr(c) for c in range(33, 127) if not chr(c).isupper()]
    tokens = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
              + sorted(set(WORDS)) + chars + ["##" + c for c in chars])
    path.write_text("\n".join(dict.fromkeys(tokens)) + "\n")


def make_requests(enc_tok, n: int, length: int, seed: int = 0) -> dict:
    """n requests (reaction SMILES + retrieved neighbour paragraphs),
    tokenized and padded to `length` with numpy; every fourth one short."""
    rng = np.random.default_rng(seed)
    ids = np.full((n, length), enc_tok.pad_token_id, np.int32)
    mask = np.zeros((n, length), np.int32)
    for i in range(n):
        n_nb, n_words = (1, 20) if i % 4 == 3 else (3, 200)
        texts = [" ".join(rng.choice(WORDS, n_words)) for _ in range(n_nb)]
        enc = enc_tok(REACTIONS[i % len(REACTIONS)], text_pair=texts)
        row = enc["input_ids"][:length]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return {"input_ids": ids, "attention_mask": mask,
            "indices": np.arange(n, dtype=np.int32),
            "example_mask": np.ones(n, np.int32)}


def set_kernels(module: torch.nn.Module, on: bool) -> None:
    """Route every layer through the kernels or through the plain
    functions (the JAX package's attention_impl / layernorm_impl flags)."""
    for m in module.modules():
        if hasattr(m, "config"):
            m.config = m.config.replace(
                attention_impl="flash" if on else "xla",
                layernorm_impl="fused" if on else "xla")


def phase_main_path(card: str, results: dict):
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        vocab = Path(tmp) / "vocab.txt"
        write_text_vocab(vocab)
        cfg = ExperimentConfig(
            task="condition", encoder="scibert_base", decoder="bert_l6",
            max_length=L, max_dec_length=DEC_LEN, num_beams=BEAMS,
            test_batch_size=B, compute_dtype="bfloat16",
            attention_impl="flash", layernorm_impl="fused",
            text_vocab_file=str(vocab))
        enc_tok, dec_tok = get_tokenizers(cfg)
    t0 = time.perf_counter()
    module, enc_cfg, dec_cfg = build_model(cfg, enc_tok, dec_tok,
                                           torch.Generator().manual_seed(0))
    module = module.to(dev).eval()
    log(f"[main] model built in {time.perf_counter() - t0:.1f} s: encoder "
        f"{enc_cfg.num_hidden_layers}x{enc_cfg.hidden_size} vocab "
        f"{enc_cfg.vocab_size}, decoder {dec_cfg.num_hidden_layers}x"
        f"{dec_cfg.hidden_size} vocab {dec_cfg.vocab_size}, "
        f"{sum(p.numel() for p in module.parameters()) / 1e6:.1f} M params")
    batch = make_requests(enc_tok, B, L)
    lens = batch["attention_mask"].sum(1)
    log(f"[main] {B} requests, tokens per request min {lens.min()} max "
        f"{lens.max()}")
    gen = Generator(module, num_beams=BEAMS, max_length=DEC_LEN)

    fused_attention.LAUNCHES = 0
    fused_layernorm.LAUNCHES = 0
    seqs, scores = gen.generate(batch)
    torch.cuda.synchronize()
    attn_n, ln_n = fused_attention.LAUNCHES, fused_layernorm.LAUNCHES
    steps = gen.last_steps
    results["fused_attention"]["launches"] = attn_n
    results["fused_layernorm"]["launches"] = ln_n
    log(f"[main] launches: attention {attn_n}, layernorm {ln_n} over "
        f"{steps} decode steps")
    enc_layers, dec_layers = enc_cfg.num_hidden_layers, dec_cfg.num_hidden_layers
    if attn_n != enc_layers:
        raise AssertionError(f"attention launches {attn_n} != {enc_layers}")
    if steps < 1 or ln_n != 2 * enc_layers + 3 * dec_layers * steps:
        raise AssertionError(f"layernorm launches {ln_n} for {steps} steps")

    preds = predictions_from_beams(seqs, scores, batch["indices"],
                                   batch["example_mask"], dec_tok)
    if seqs.shape != (B, BEAMS, DEC_LEN) or scores.shape != (B, BEAMS):
        raise AssertionError(f"shapes {seqs.shape} {scores.shape}")
    if not np.isfinite(scores).all():
        raise AssertionError("non-finite beam scores")
    if not (np.diff(scores, axis=1) <= 0).all():
        raise AssertionError("beam scores increase across beams")
    if len(preds) != B or any(len(p["prediction"]) != BEAMS
                              for p in preds.values()):
        raise AssertionError("predictions_from_beams lost requests")
    log(f"[main] request 0 best beam {preds[0]['prediction'][0]} score "
        f"{preds[0]['score'][0]:.3f}")

    ids = torch.as_tensor(batch["input_ids"], dtype=torch.long, device=dev)
    mask = torch.as_tensor(batch["attention_mask"], device=dev)
    batch_ms = wall_ms(lambda: gen.generate(batch))
    with torch.inference_mode():
        enc_ms = wall_ms(lambda: module.encode(ids, mask))
    log(f"[main] {batch_ms:.1f} ms/batch (host clock, median of 5) for B={B} "
        f"L={L} beam {BEAMS} dec {DEC_LEN}, {gen.last_steps} decode steps, "
        f"on {card}; the encoder alone {enc_ms:.1f} ms, cache set-up and "
        f"beam search the other {batch_ms - enc_ms:.1f} ms. Random weights "
        f"rarely emit EOS, so this is the worst case with no early stop.")

    return cfg, enc_tok, dec_tok, module, ids, mask


def phase_end_to_end(cfg, enc_tok, dec_tok, module: torch.nn.Module,
                     ids: torch.Tensor, mask: torch.Tensor) -> None:
    """The batch's encoder states through the kernels and through the plain
    functions: the bf16 serving model, and the same seed built in f32."""
    f32, _, _ = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                            enc_tok, dec_tok, torch.Generator().manual_seed(0))
    f32 = f32.to(ids.device).eval()
    for name, m in (("bfloat16", module), ("float32", f32)):
        with torch.inference_mode():
            with_kernels = m.encode(ids, mask)
            set_kernels(m, False)
            launches = (fused_attention.LAUNCHES, fused_layernorm.LAUNCHES)
            plain = m.encode(ids, mask)
            set_kernels(m, True)
        torch.cuda.synchronize()
        if (fused_attention.LAUNCHES, fused_layernorm.LAUNCHES) != launches:
            raise AssertionError("the plain encoder pass launched a kernel")
        diff = float((with_kernels.float() - plain.float()).abs().max())
        log(f"[e2e] encoder states, kernels vs plain functions, {name}: max "
            f"abs diff {diff:.3e} (bound {ENCODER_BOUND[name]:g})")
        if not diff <= ENCODER_BOUND[name]:
            raise AssertionError(f"{name} encoder with kernels departs from "
                                 f"the plain path")


def main() -> int:
    card = phase_device()
    phase_build()
    results: dict = {}
    phase_kernels(results)
    phase_end_to_end(*phase_main_path(card, results))
    kernels = [dict(name=name, **meta, launches=results[name]["launches"],
                    max_abs_err=results[name]["max_abs_err"],
                    ms=results[name]["ms"], plain_ms=results[name]["plain_ms"])
               for name, meta in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
