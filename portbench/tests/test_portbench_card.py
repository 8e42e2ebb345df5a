"""On the card: the reference's dropout masks are the port's kernels' own
(their test-only mask exports). Skips without a CUDA device."""

from __future__ import annotations

import pytest
import torch

from portbench.reference import encdec


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the masks are the card kernels'")
    return torch.device("cuda")


@pytest.mark.cuda
def test_masks_are_the_kernels(card):
    from textreact_tpu_torch.ops import fused_attention, fused_layernorm
    seed = torch.tensor([0x123456789ABCDEF], dtype=torch.int64, device=card)
    s = int(seed)
    want = fused_attention.keep_mask(seed, 2, 3, 128, 0.1)
    got = encdec.attention_keep(s, 2, 3, 128, 128, 0.1, card)
    assert torch.equal(want.bool(), got)
    want = fused_layernorm.keep_mask(seed, 300, 768, 0.1)
    assert torch.equal(want.bool(), encdec.row_keep(s, 300, 768, 0.1, card))
