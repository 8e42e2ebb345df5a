"""The yardstick's arithmetic against hand counts at a small size: one
encoder layer, one decode step, one attention call; the traffic's fixed
sizes; the reference's Philox against its published known answers."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import flops, traffic
from portbench.reference import encdec

ENC = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 1,
       "vocab_size": 50}
DEC = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 1,
       "vocab_size": 30}


def test_encoder_layer_flops():
    # one layer, prompts of 3 and 5 tokens: Q, K, V, O (4 products of
    # n x 8 by 8 x 8), FFN (n x 8 by 8 x 16 and back), QK and PV over n keys
    n = 8
    linear = 2 * n * (4 * 8 * 8 + 2 * 8 * 16)
    attention = 2 * 2 * (3 * 3 + 5 * 5) * 8
    assert flops.encoder_flops([3, 5], ENC) == linear + attention


def test_decode_step_flops():
    # one token, 4 cached keys, 6 encoder keys: self Q K V O, cross Q O,
    # FFN, QK and PV over 4 + 6 keys, LM head transform and vocabulary
    per_layer = 2 * (6 * 8 * 8 + 2 * 8 * 16) + 2 * 2 * 8 * (4 + 6)
    head = 2 * 8 * 8 + 2 * 8 * 30
    assert flops.decoder_token_flops(DEC, 4, 6) == per_layer + head


def test_serve_batch_flops():
    mask = np.array([[1, 1, 0], [1, 1, 1]])
    beams, steps = 2, 3
    want = flops.encoder_flops([2, 3], ENC) + flops.cross_kv_flops(
        [2, 3], DEC)
    for n in (2, 3):
        for s in (1, 2, 3):
            want += beams * flops.decoder_token_flops(DEC, s, n)
    assert flops.serve_batch_flops(mask, beams, steps, ENC, DEC) == want


def test_attention_bounds():
    # B=1, L=4, 2 keys admitted, 2 heads of 8, bf16
    mask = np.array([[1, 1, 0, 0]])
    b = flops.attention_bounds(mask, 2, 8)
    pairs = 4 * 2 * 16
    fwd_bytes = 4 * 16 * 2 * 2 + 2 * 2 * 16 * 2 + 4 * 4 + 2 * 4 * 8
    assert b["fwd"] == max(4 * pairs / flops.PEAK_FLOPS,
                           fwd_bytes / flops.PEAK_BYTES)
    bwd_bytes = 4 * 16 * 2 * 4 + 4 * 2 * 16 * 2 + 4 * 4 + 2 * 4 * 8
    assert b["bwd"] == max(10 * pairs / flops.PEAK_FLOPS,
                           bwd_bytes / flops.PEAK_BYTES)


def test_layernorm_bounds_are_bytes():
    b = flops.layernorm_bounds(16384, 768)
    assert b["fwd"] == pytest.approx(
        (16384 * 768 * 6 + 2 * 768 * 4 + 16384 * 8) / flops.PEAK_BYTES)


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3])
def test_traffic_sizes_fixed_across_seeds(seed):
    cfg = {"encoder_ids": {"pad": 0, "cls": 2, "sep": 3, "mask": 4,
                           "first_word": 5, "vocab_size": 300},
           "decoder_ids": {"pad": 0, "bos": 1, "eos": 2, "first_token": 3,
                           "last_token": 39},
           "length_buckets": [64, 128], "dec_length_buckets": [16, 32]}
    mix = {"micro_batches": 2, "micro_batch_size": 8, "pool_steps": 2,
           "prompt": {"length": 128, "long_share": 0.75,
                      "short_lengths": [16, 64]},
           "mlm": {"ratio": 0.15, "mean_span": 3, "max_span": 10},
           "target": {"fixed": 12}}
    pool = traffic.train_pool(mix, cfg, seed)
    lengths = sorted(int(x) for s in pool
                     for x in s["attention_mask"].sum(-1).ravel())
    masked = sorted(int(x) for s in pool
                    for x in (s["mlm_labels"] != -100).sum(-1).ravel())
    keys = sorted(s["decoder_input_ids"].shape for s in pool)
    base = traffic.train_pool(mix, cfg, 1)
    assert lengths == sorted(int(x) for s in base
                             for x in s["attention_mask"].sum(-1).ravel())
    assert masked == sorted(int(x) for s in base
                            for x in (s["mlm_labels"] != -100).sum(-1).ravel())
    assert keys == sorted(s["decoder_input_ids"].shape for s in base)
    for s in pool:   # masked tokens first, positions kept
        n = int(s["attention_mask"][0, 0].sum())
        ids, pos = s["input_ids"][0, 0, :n], s["position_ids"][0, 0, :n]
        m = int((s["mlm_labels"][0, 0] != -100).sum())
        assert m == int(n * 0.15) and (ids[:m] == 4).all()
        assert sorted(pos.tolist()) == list(range(n))


def test_philox_known_answers():
    """Random123's kat_vectors for philox4x32_10."""
    m = 0xFFFFFFFF
    assert encdec.philox(0, 0, 0, 0, 0) == (
        0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)
    assert encdec.philox(m, m, m, m, (m << 32) | m) == (
        0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)
    assert encdec.philox(0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344,
                         (0x299f31d0 << 32) | 0xa4093822) == (
        0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)
