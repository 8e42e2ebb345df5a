"""The template-based model's spans and counter, on the CPU at a tiny size.

`SPANS` names the plain attention path (`attention.plain`) and the
template heads (`template.head`); an uncaptured template train step under
`torch.profiler` opens the first once per encoder layer and micro-batch
and the second once per micro-batch. The plain path's counter of calls
under a 3-D mask (models/layers.py `PLAIN_MASK_3D_CALLS`) adds one per
encoder layer in a forward under the (B, L, L) bond mask, and none under a
(B, L) mask or in the encoder-decoder's plain attention, whose biases come
from (B, L) masks. The card's replays of the counter are in
tests/test_torch_template_graphs.py.
"""

import _torch_threads  # noqa: F401  (before torch runs)
from collections import Counter

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import traffic_template
from portbench.tests import tiny_template
from textreact_tpu_torch.config import ExperimentConfig
from textreact_tpu_torch.models import (EncoderDecoder, TemplateBasedModel,
                                        TransformerConfig, layers)
from textreact_tpu_torch.train import (TrainState, make_accum_train_step,
                                       make_optimizer)
from textreact_tpu_torch.utils.profiling import SPANS

LAYERS, MICRO = 2, 2


def _module(attention_impl: str = "flash") -> TemplateBasedModel:
    torch.manual_seed(0)
    enc = TransformerConfig(vocab_size=340, hidden_size=128,
                            num_hidden_layers=LAYERS, num_attention_heads=2,
                            intermediate_size=256,
                            max_position_embeddings=128,
                            attention_impl=attention_impl,
                            layernorm_impl="fused")
    return TemplateBasedModel(enc, 10, 6, dtype=torch.float32,
                              mlm_layer="mlp")


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


def test_an_uncaptured_template_step_opens_them():
    module = _module()
    cfg = ExperimentConfig(task="retro", template_based=True,
                           unattend_nonbonds=True, template_path="x",
                           mlm=True, lr=1e-3, scheduler="constant")
    opt = make_optimizer(cfg, 10, module.named_parameters())
    step = make_accum_train_step(module, cfg, opt, 0, device="cpu")
    state = TrainState.create(module, opt)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, _arrays(), np.ones(MICRO, np.float32), 0)
    names = Counter(ev.name for ev in prof.events() if ev.name in SPANS)
    assert names == {"train.step": 1, "train.stage": MICRO,
                     "train.micro": MICRO, "train.update": 1,
                     "attention.plain": LAYERS * MICRO,
                     "template.head": MICRO}


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
