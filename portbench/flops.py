"""The yardstick's arithmetic: model FLOPs of a train step and of a served
batch, and the least time the fused kernels could take, from the
configuration's sizes and the traffic's shapes alone (nothing is read from
the program).

Model FLOPs count every matrix product of the model on the real tokens (a
prompt's or target's mask), with attention over the keys the mask admits
(causal: the keys at or before the query). A product of m x k by k x n is
2 m k n. Training counts the forward three times; no recomputation counts.
Serving counts the encoder, the cross-attention keys and values once an
example, and each decode step of every beam row, its self-attention over
the positions decoded so far.

Kernel bounds (the fused attention and residual LayerNorm kernels): the
larger of the operations over 989 TFLOP/s (bf16 tensor cores) and the bytes
over 3.35 TB/s (HBM3), NVIDIA's H100 SXM data sheet; each input byte read
once and each output byte written once; a key the mask bars is neither
read nor multiplied.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

PEAK_FLOPS = 989e12      # H100 SXM, dense bf16
PEAK_BYTES = 3.35e12     # H100 SXM, HBM3


def encoder_flops(lengths: Sequence[int], cfg: dict) -> float:
    """Forward FLOPs of the encoder over prompts of these real lengths."""
    d, f, n = (cfg["hidden_size"], cfg["intermediate_size"],
               cfg["num_hidden_layers"])
    n_tok = float(np.sum(lengths))
    pairs = float(np.sum(np.square(np.asarray(lengths, dtype=np.float64))))
    per_layer = n_tok * (8 * d * d + 4 * d * f) + 4 * d * pairs
    return n * per_layer


def cross_kv_flops(lengths: Sequence[int], dec: dict) -> float:
    """The decoder's cross-attention keys and values of the prompts."""
    d = dec["hidden_size"]
    return dec["num_hidden_layers"] * float(np.sum(lengths)) * 4 * d * d


def decoder_token_flops(dec: dict, self_keys: float, cross_keys: float
                        ) -> float:
    """One decoder token through every layer and the LM head, attending
    over `self_keys` and `cross_keys` keys."""
    d, f, V = dec["hidden_size"], dec["intermediate_size"], dec["vocab_size"]
    layer = 12 * d * d + 4 * d * f + 4 * d * (self_keys + cross_keys)
    return dec["num_hidden_layers"] * layer + 2 * d * d + 2 * d * V


def mlm_flops(labels: int, enc: dict) -> float:
    d = enc["hidden_size"]
    return labels * (2 * d * d + 2 * d * enc["vocab_size"])


def train_step_flops(step: Dict[str, np.ndarray], enc: dict, dec: dict
                     ) -> float:
    """Model FLOPs of one optimizer step over stacked micro-batches: the
    forward (encoder, MLM head on the labelled positions, teacher-forced
    decoder) times three."""
    fwd = 0.0
    for mb in range(step["input_ids"].shape[0]):
        lengths = step["attention_mask"][mb].sum(-1)
        targets = step["decoder_attention_mask"][mb].sum(-1)
        fwd += encoder_flops(lengths, enc) + cross_kv_flops(lengths, dec)
        fwd += mlm_flops(int((step["mlm_labels"][mb] != -100).sum()), enc)
        for n, t in zip(lengths, targets):
            # position i attends over i + 1 causal keys
            fwd += t * decoder_token_flops(dec, 0.0, float(n))
            fwd += (dec["num_hidden_layers"] * 4 * dec["hidden_size"]
                    * t * (t + 1) / 2)
    return 3.0 * fwd


def serve_batch_flops(mask: np.ndarray, beams: int, steps: int, enc: dict,
                      dec: dict) -> float:
    """Model FLOPs of one served batch: encoder, cross keys and values, and
    `steps` decode steps of every beam row."""
    lengths = mask.sum(-1)
    total = encoder_flops(lengths, enc) + cross_kv_flops(lengths, dec)
    for n in lengths:
        for s in range(1, steps + 1):
            total += beams * decoder_token_flops(dec, float(s), float(n))
    return total


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def attention_bounds(mask: np.ndarray, heads: int, head_dim: int,
                     elem: int = 2) -> Dict[str, float]:
    """Bound seconds of one fused attention forward and backward over a
    (B, L) key mask: every query row's output, the admitted keys."""
    B, L = mask.shape
    keys = mask.sum(-1).astype(np.float64)
    hd = heads * head_dim
    row = L * hd * elem                    # one example's q, out, dout, ...
    kv = keys * hd * elem                  # one example's admitted k or v
    stats = B * heads * L * 8              # row max and normaliser, f32
    pairs = float(L * keys.sum()) * hd     # query rows x admitted keys x hd
    fwd_bytes = B * row * 2 + 2 * kv.sum() + B * L * 4 + stats
    bwd_bytes = B * row * 4 + 4 * kv.sum() + B * L * 4 + stats
    return {"fwd": bound_s(4 * pairs, fwd_bytes),
            "bwd": bound_s(10 * pairs, bwd_bytes)}


def layernorm_bounds(rows: int, hidden: int, elem: int = 2,
                     training: bool = True) -> Dict[str, float]:
    """Bound seconds of one residual LayerNorm forward (x, y in; out, and in
    training the row mean and rstd, out) and backward (x, y, g, mean, rstd
    in; dx, dy, dscale, dbias out)."""
    params = 2 * hidden * 4
    stats = rows * 8 if training else 0
    fwd = rows * hidden * elem * 3 + params + stats
    bwd = rows * hidden * elem * 5 + hidden * 4 + rows * 8 + params
    return {"fwd": bound_s(8.0 * rows * hidden, fwd),
            "bwd": bound_s(12.0 * rows * hidden, bwd)}
