"""The template-based model's spans and counters at a tiny size, on the CPU
and, in one case, on the card.

`SPANS` names the plain attention path (`attention.plain`) and the
template heads (`template.head`); an uncaptured template train step under
`torch.profiler` opens the first once per encoder layer and micro-batch
and the second once per micro-batch. The plain path's counter of calls
under a 3-D mask (models/layers.py `PLAIN_MASK_3D_CALLS`) adds one per
encoder layer in a forward under the (B, L, L) bond mask, and none under a
(B, L) mask or in the encoder-decoder's plain attention, whose biases come
from (B, L) masks. On the card, where the bf16 encoder's layers take the fused
kernels under the packed bond mask, the same step opens `attention.mask_3d`
in their place and counts packed-mask launches (ops/fused_attention.py
`MASK_3D_LAUNCHES`), no plain call. The card's replays of the counters are
in tests/test_torch_template_graphs.py.
"""

import _torch_threads  # noqa: F401  (before torch runs)
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import traffic_template
from portbench.tests import tiny_template
from textreact_tpu_torch.config import ExperimentConfig
from textreact_tpu_torch.models import (EncoderDecoder, TemplateBasedModel,
                                        TransformerConfig, layers)
from textreact_tpu_torch.ops import fused_attention
from textreact_tpu_torch.train import (TrainState, make_accum_train_step,
                                       make_optimizer)
from textreact_tpu_torch.utils.profiling import SPANS

LAYERS, MICRO = 2, 2


def _module(attention_impl: str = "flash",
            dtype: torch.dtype = torch.float32) -> TemplateBasedModel:
    torch.manual_seed(0)
    enc = TransformerConfig(vocab_size=340, hidden_size=128,
                            num_hidden_layers=LAYERS, num_attention_heads=2,
                            intermediate_size=256,
                            max_position_embeddings=128,
                            attention_impl=attention_impl,
                            layernorm_impl="fused")
    return TemplateBasedModel(enc, 10, 6, dtype=dtype, mlm_layer="mlp")


def _arrays(seed: int = 0) -> dict:
    mix = dict(tiny_template.TRAIN, micro_batches=MICRO)
    return traffic_template.pool(mix, tiny_template.CONFIG, seed)[0]


def _forward(module, arrays, mask) -> None:
    batch = {k: torch.as_tensor(v[0], dtype=torch.long)
             for k, v in arrays.items()}
    with torch.no_grad():
        module(batch["input_ids"], mask(batch["attention_mask"]),
               batch["atom_indices"], batch["bond_pairs"],
               position_ids=batch["position_ids"])


def test_spans_name_the_plain_path_and_the_heads():
    assert {"attention.plain", "template.head"} <= set(SPANS)


def _uncaptured_step_spans(module, device: str) -> Counter:
    cfg = ExperimentConfig(task="retro", template_based=True,
                           unattend_nonbonds=True, template_path="x",
                           mlm=True, lr=1e-3, scheduler="constant")
    opt = make_optimizer(cfg, 10, module.named_parameters())
    step = make_accum_train_step(module, cfg, opt, 0, device=device)
    step.route = "uncaptured"
    state = TrainState.create(module, opt)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, _arrays(), np.ones(MICRO, np.float32), 0)
    return Counter(ev.name for ev in prof.events() if ev.name in SPANS)


def test_an_uncaptured_template_step_opens_them():
    names = _uncaptured_step_spans(_module(), "cpu")
    assert names == {"train.step": 1, "train.stage": MICRO,
                     "train.micro": MICRO, "train.update": 1,
                     "attention.plain": LAYERS * MICRO,
                     "template.head": MICRO}


@pytest.mark.cuda
def test_a_card_step_takes_the_packed_route():
    """bf16 on the card: every layer's self-attention under the bond mask
    takes the fused kernels (`attention.mask_3d`, a launch forward and
    backward each), none the plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    module = _module(dtype=torch.bfloat16).cuda()
    plain, packed = (layers.PLAIN_MASK_3D_CALLS,
                     dict(fused_attention.MASK_3D_LAUNCHES))
    names = _uncaptured_step_spans(module, "cuda")
    torch.cuda.synchronize()
    assert names == {"train.step": 1, "train.stage": MICRO,
                     "train.micro": MICRO, "train.update": 1,
                     "attention.mask_3d": LAYERS * MICRO,
                     "template.head": MICRO}
    assert layers.PLAIN_MASK_3D_CALLS == plain
    assert fused_attention.MASK_3D_LAUNCHES == {
        "fwd": packed["fwd"] + LAYERS * MICRO,
        "bwd": packed["bwd"] + LAYERS * MICRO}


def test_the_counter_adds_one_call_a_layer_under_the_bond_mask():
    arrays = _arrays(1)
    assert arrays["attention_mask"].ndim == 4
    for impl in ("flash", "xla"):
        module = _module(impl)
        before = layers.PLAIN_MASK_3D_CALLS
        _forward(module, arrays, lambda m: m)
        assert layers.PLAIN_MASK_3D_CALLS - before == LAYERS
        # the key mask: the fused path ("flash") or the plain path under a
        # (B, 1, 1, L) bias ("xla"), counted by neither
        _forward(module, arrays, lambda m: m.diagonal(dim1=1, dim2=2))
        assert layers.PLAIN_MASK_3D_CALLS - before == LAYERS


def test_the_encoder_decoders_plain_attention_is_not_counted():
    enc = TransformerConfig(vocab_size=32, hidden_size=64,
                            num_hidden_layers=1, num_attention_heads=2,
                            intermediate_size=128, max_position_embeddings=32)
    dec = enc.replace(is_decoder=True, add_cross_attention=True,
                      bos_token_id=1, eos_token_id=2, pad_token_id=0)
    module = EncoderDecoder(enc, dec, dtype=torch.float32)
    ids = torch.randint(3, 32, (2, 16))
    before = layers.PLAIN_MASK_3D_CALLS
    with torch.no_grad():
        module(ids, torch.ones(2, 16, dtype=torch.long), ids[:, :8],
               torch.ones(2, 8, dtype=torch.long))
    assert layers.PLAIN_MASK_3D_CALLS == before
