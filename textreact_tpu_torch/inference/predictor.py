"""Generation: encoder forward + cached beam-search decoding (twin of
textreact_tpu/inference/predictor.py)."""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.encdec import DecoderStep, EncoderDecoder
from ..utils.profiling import span
from .beam import beam_search
from .graphs import GraphedDecode

# the decode's routes: CUDA graphs (the card's), or the same device-state
# loop uncaptured (the CPU's, and the card's under tensor parallelism,
# whose collectives the graphs do not hold)
CUDA_GRAPHS, UNCAPTURED = "cuda_graphs", "uncaptured"


def decode_route(device: torch.device, tp_size: int) -> str:
    """The route of a Generator whose module lies on `device`, its decoder
    cut over `tp_size` ranks: graphs on a card, unless the step holds a
    collective (tp > 1: gloo cannot be captured, and NCCL capture is not
    done yet)."""
    return (CUDA_GRAPHS if device.type == "cuda" and tp_size == 1
            else UNCAPTURED)


class Generator:
    """Serving entry point: batch arrays in, beams and scores out (numpy).

    As the JAX Generator, it decodes through the row-stable grouped beam
    cache (`DecoderStep(beam_groups=num_beams)`) over the static window
    schedule of `attn_windows` (inference/beam.py::_plan_windows; None
    lets it choose), and the search's state lives on the device.

    `route` is chosen once, here (`decode_route`). On "cuda_graphs" the
    Generator is the JAX one's compiled program with graphs in place of
    XLA's (inference/graphs.py): per key of (input shape, mask shape,
    compute dtype) it holds static buffers and CUDA graphs, captured at
    the key's first batch and replayed for every later batch of that key; a
    new key frees them and captures again. A graph reads the module's
    parameters where they lie at capture. On "uncaptured" the same loop
    runs as it is; setting `route` to it before a call runs the card's
    batch that way, the reference the graphs are held to."""

    def __init__(self, module: EncoderDecoder, num_beams: int,
                 max_length: int,
                 attn_windows: Optional[Sequence[int]] = None):
        self.module = module
        self.num_beams = num_beams
        self.max_length = max_length
        self.dec_config = module.decoder_config
        self.attn_windows = attn_windows
        self.step_model = DecoderStep(module.decoder, beam_groups=num_beams)
        tp = module.decoder.layers[0].attention.tp
        self.route = decode_route(module.decoder.word_embedding.device,
                                  1 if tp is None else tp.size)
        self.last_steps = 0     # decode steps the last batch ran
        # the decode steps the card ran for it: graph replays, or calls of
        # the uncaptured body; past a stop up to beam.STOP_LAG more than
        # last_steps, which change nothing
        self.last_replays = 0
        self.last_capture_ms = 0.0  # spent capturing graphs in the last call
        self._key = None
        self._graphed = None

    @torch.inference_mode()
    def generate(self, batch: Mapping[str, np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """batch: 'input_ids' (B, L) and 'attention_mask' (B, L) or
        (B, L, L). Returns (sequences (B, K, max_length), scores (B, K)).
        The call is the span `serve.batch` (utils/profiling.py)."""
        with span("serve.batch"):
            self.module.eval()  # no dropout, whatever a train step left on
            input_ids = np.asarray(batch["input_ids"])
            attention_mask = np.asarray(batch["attention_mask"])
            # cuBLAS may otherwise reduce a bf16 product's partial sums in
            # bf16; the reference (the JAX package on its MXU) accumulates
            # in f32. A graph keeps the algorithms chosen at its capture,
            # so this holds for capture and replay alike.
            matmul = torch.backends.cuda.matmul
            reduced = matmul.allow_bf16_reduced_precision_reduction
            matmul.allow_bf16_reduced_precision_reduction = False
            try:
                if self.route == CUDA_GRAPHS:
                    return self._generate_graphed(input_ids, attention_mask)
                return self._generate_uncaptured(input_ids, attention_mask)
            finally:
                matmul.allow_bf16_reduced_precision_reduction = reduced

    def _generate_graphed(self, input_ids: np.ndarray,
                          attention_mask: np.ndarray):
        key = (input_ids.shape, attention_mask.shape, self.module.dtype)
        if self._key != key:
            self._graphed = None   # frees the old key's graphs and buffers
            self._graphed = GraphedDecode(
                self.module, self.step_model, self.num_beams,
                self.max_length, self.attn_windows, input_ids.shape,
                attention_mask.shape)
            self._key = key
        graphed = self._graphed
        before = graphed.capture_ms
        seqs, scores, self.last_steps, self.last_replays = graphed.run(
            input_ids, attention_mask)
        self.last_capture_ms = graphed.capture_ms - before
        return seqs, scores

    def _generate_uncaptured(self, input_ids: np.ndarray,
                             attention_mask: np.ndarray):
        device = self.module.decoder.word_embedding.device
        with span("serve.stage"):
            ids = torch.as_tensor(input_ids, dtype=torch.long, device=device)
            mask = torch.as_tensor(attention_mask, dtype=torch.int32,
                                   device=device)
        K, T = self.num_beams, self.max_length
        cfg = self.dec_config
        with span("serve.prologue"):
            enc = self.module.encode(ids, mask)
            # encoder states and mask stay one row per example; beams
            # attend as grouped query rows (layers.py decode_cross)
            cache = self.step_model.init_cache(enc, mask, K, T)
        calls = [0]

        def step_fn(tokens, pos, bias):
            calls[0] += 1
            return self.step_model(tokens, cache, pos, bias)

        seqs, scores, self.last_steps = beam_search(
            step_fn, ids.shape[0], K, T, bos_token_id=cfg.bos_token_id,
            eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
            attn_windows=self.attn_windows, device=device)
        self.last_replays, self.last_capture_ms = calls[0], 0.0
        with span("serve.readback"):
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
