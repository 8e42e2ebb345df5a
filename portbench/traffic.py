"""The one traffic generator: reads a mix's parameters
(`portbench/traffic/<name>.json`) and makes its pool of requests or
training micro-batches from the seed, as collated numpy arrays.

Every seed gets the same sizes: each micro-batch or batch takes its
prompt lengths, masked-token counts and target lengths from fixed grids
(quantiles of the stated distributions), and the seed draws the token ids,
the span positions and the order. So two seeds do the same work in
another order, and the shape keys a pool yields are the same.

A prompt is a reaction with its retrieved paragraphs: [CLS] ids [SEP] ids
[SEP], ids drawn from the encoder's word range, at the encoder length
(`long_share`, by default all) or on a grid over `short_lengths`.
Training applies span MLM (spans of Poisson lengths, no overlaps, exactly
int(n * ratio) tokens masked) with the masked tokens moved first and their
positions kept, as the port's loader does, and pads as the collator does
(`collate`). Each mix names the source of its sizes under `source`.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
IGNORE_INDEX = -100


def load(name: str) -> dict:
    path = HERE / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def _grid(lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths spread evenly over [lo, hi]."""
    if n == 1:
        return np.array([(lo + hi) // 2])
    return np.round(np.linspace(lo, hi, n)).astype(int)


def prompt_lengths(spec: dict, n: int) -> np.ndarray:
    """The prompt lengths of a batch of n: round(long_share * n) at the
    encoder length, the rest on a grid over `short_lengths`."""
    long_n = int(round(spec.get("long_share", 1.0) * n))
    if long_n == n:
        return np.full(n, spec["length"])
    lo, hi = spec["short_lengths"]
    return np.concatenate([np.full(long_n, spec["length"]),
                           _grid(lo, hi, n - long_n)])


def prompt(rng: np.random.Generator, length: int, ids: dict) -> np.ndarray:
    row = rng.integers(ids["first_word"], ids["vocab_size"], size=length)
    row[0] = ids["cls"]
    row[length - 1] = ids["sep"]
    row[max(1, length // 8)] = ids["sep"]
    return row


def span_mlm(rng: np.random.Generator, row: np.ndarray, spec: dict,
             mask_id: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ids, position ids, labels) with int(n * ratio) tokens masked in
    non-overlapping spans, masked tokens first."""
    n = len(row)
    m = int(n * spec["ratio"])
    spans: List[int] = []
    while sum(spans) < m:
        k = int(np.clip(rng.poisson(spec["mean_span"]), 1, spec["max_span"]))
        spans.append(min(k, m - sum(spans)))
    # the unmasked tokens split into len(spans) + 1 gaps
    cuts = np.sort(rng.integers(0, n - m + 1, size=len(spans)))
    gaps = np.diff(np.concatenate([[0], cuts, [n - m]]))
    masked = np.zeros(n, bool)
    at = 0
    for gap, k in zip(gaps, spans):
        at += gap
        masked[at:at + k] = True
        at += k
    order = np.concatenate([np.flatnonzero(masked), np.flatnonzero(~masked)])
    ids = np.where(masked, mask_id, row)[order]
    return ids, order, row[masked]


def _pad(rows: List[np.ndarray], length: int, pad: int) -> np.ndarray:
    out = np.full((len(rows), length), pad, np.int32)
    for i, r in enumerate(rows):
        out[i, :min(len(r), length)] = r[:length]
    return out


def bucket(n: int, buckets) -> int:
    """The smallest bucket that holds n (the last one caps)."""
    return next((b for b in buckets if n <= b), buckets[-1])


def collate_train(rows: List[dict], cfg: dict) -> Dict[str, np.ndarray]:
    """The collator's arrays of one micro-batch: prompts padded to their
    length bucket, the MLM labels to a multiple of 16 (at least 16, at most
    the prompt length), targets to their decoder bucket."""
    enc_ids, dec_ids = cfg["encoder_ids"], cfg["decoder_ids"]
    L = bucket(max(len(r["ids"]) for r in rows), cfg["length_buckets"])
    max_m = max(len(r["labels"]) for r in rows)
    M = min(L, max(16, -(-max_m // 16) * 16))
    Ld = bucket(max(len(r["target"]) for r in rows), cfg["dec_length_buckets"])
    return {
        "input_ids": _pad([r["ids"] for r in rows], L, enc_ids["pad"]),
        "attention_mask": _pad([np.ones(len(r["ids"])) for r in rows], L, 0),
        "position_ids": _pad([r["pos"] for r in rows], L, 0),
        "mlm_labels": _pad([r["labels"] for r in rows], M, IGNORE_INDEX),
        "decoder_input_ids": _pad([r["target"] for r in rows], Ld,
                                  dec_ids["pad"]),
        "decoder_attention_mask": _pad([np.ones(len(r["target"]))
                                        for r in rows], Ld, 0),
    }


def _target(rng, n: int, ids: dict) -> np.ndarray:
    t = rng.integers(ids["first_token"], ids["last_token"] + 1, size=n)
    t[0], t[-1] = ids["bos"], ids["eos"]
    return t


def train_pool(mix: dict, cfg: dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """`pool_steps` optimizer steps, each a dict of arrays stacked on a
    leading axis of `micro_batches` (one shape key a step); every target
    has `target.fixed` tokens, its special tokens included."""
    rng = np.random.default_rng(seed)
    B, n_micro = mix["micro_batch_size"], mix["micro_batches"]
    enc_ids = cfg["encoder_ids"]
    target = mix["target"]["fixed"]
    steps = []
    for _ in range(mix["pool_steps"]):
        micro = []
        for _ in range(n_micro):
            lengths = rng.permutation(prompt_lengths(mix["prompt"], B))
            rows = []
            for n in lengths:
                ids, pos, labels = span_mlm(
                    rng, prompt(rng, int(n), enc_ids), mix["mlm"],
                    enc_ids["mask"])
                rows.append({"ids": ids, "pos": pos, "labels": labels,
                             "target": _target(rng, target,
                                               cfg["decoder_ids"])})
            micro.append(collate_train(rows, cfg))
        steps.append({k: np.stack([m[k] for m in micro]) for k in micro[0]})
    order = rng.permutation(len(steps))
    steps = [steps[i] for i in order]
    return steps


def serve_pool(mix: dict, cfg: dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """`pool_batches` batches of `batch_size` prompts, padded to the
    encoder length."""
    rng = np.random.default_rng(seed)
    B, L = mix["batch_size"], mix["prompt"]["length"]
    enc_ids = cfg["encoder_ids"]
    pool = []
    for _ in range(mix["pool_batches"]):
        lengths = rng.permutation(prompt_lengths(mix["prompt"], B))
        rows = [prompt(rng, int(n), enc_ids) for n in lengths]
        pool.append({
            "input_ids": _pad(rows, L, enc_ids["pad"]),
            "attention_mask": _pad([np.ones(len(r)) for r in rows], L, 0)})
    return pool
