"""Generation: encoder forward + cached beam-search decoding (twin of
textreact_tpu/inference/predictor.py)."""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.encdec import DecoderStep, EncoderDecoder
from .beam import beam_search


class Generator:
    """Serving entry point: batch arrays in, beams and scores out (numpy).

    As the JAX Generator, it decodes through the row-stable grouped beam
    cache (`DecoderStep(beam_groups=num_beams)`) over the static window
    schedule of `attn_windows` (inference/beam.py::_plan_windows; None
    lets it choose)."""

    def __init__(self, module: EncoderDecoder, num_beams: int,
                 max_length: int,
                 attn_windows: Optional[Sequence[int]] = None):
        self.module = module
        self.num_beams = num_beams
        self.max_length = max_length
        self.dec_config = module.decoder_config
        self.attn_windows = attn_windows
        self.step_model = DecoderStep(module.decoder, beam_groups=num_beams)
        self.last_steps = 0  # decode steps the last batch ran

    @torch.inference_mode()
    def generate(self, batch: Mapping[str, np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """batch: 'input_ids' (B, L) and 'attention_mask' (B, L) or
        (B, L, L). Returns (sequences (B, K, max_length), scores (B, K))."""
        self.module.eval()  # no dropout, whatever a train step left on
        device = self.module.decoder.word_embedding.device
        input_ids = torch.as_tensor(np.asarray(batch["input_ids"]),
                                    dtype=torch.long, device=device)
        attention_mask = torch.as_tensor(np.asarray(batch["attention_mask"]),
                                         dtype=torch.int32, device=device)
        B, K, T = input_ids.shape[0], self.num_beams, self.max_length
        # cuBLAS may otherwise reduce a bf16 product's partial sums in bf16;
        # the reference (the JAX package on its MXU) accumulates in f32
        matmul = torch.backends.cuda.matmul
        reduced = matmul.allow_bf16_reduced_precision_reduction
        matmul.allow_bf16_reduced_precision_reduction = False
        try:
            enc = self.module.encode(input_ids, attention_mask)
            # encoder states and mask stay one row per example; beams
            # attend as grouped query rows (layers.py decode_cross)
            cache = self.step_model.init_cache(enc, attention_mask, K, T)
            cfg = self.dec_config
            seqs, scores, self.last_steps = beam_search(
                lambda tokens, pos, bias: self.step_model(tokens, cache, pos,
                                                          bias),
                B, K, T, bos_token_id=cfg.bos_token_id,
                eos_token_id=cfg.eos_token_id,
                pad_token_id=cfg.pad_token_id,
                attn_windows=self.attn_windows, device=device)
        finally:
            matmul.allow_bf16_reduced_precision_reduction = reduced
        return seqs.cpu().numpy(), scores.cpu().numpy()


def predictions_from_beams(seqs: np.ndarray, scores: np.ndarray,
                           indices: np.ndarray, example_mask: np.ndarray,
                           dec_tokenizer) -> Dict[int, Dict[str, Any]]:
    """{example index: {'prediction': [K decoded], 'score': [K floats]}}
    (reference main.py:224-233)."""
    out: Dict[int, Dict[str, Any]] = {}
    B, K, _ = seqs.shape
    for b in range(B):
        if not example_mask[b]:
            continue
        preds: List[Any] = [
            dec_tokenizer.decode(seqs[b, k].tolist(), skip_special_tokens=True)
            for k in range(K)
        ]
        out[int(indices[b])] = {
            "prediction": preds,
            "score": [float(s) for s in scores[b]],
        }
    return out
