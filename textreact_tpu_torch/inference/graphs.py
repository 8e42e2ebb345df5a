"""The Generator's compiled decode on the card: CUDA graphs in place of the
JAX package's one jitted program (textreact_tpu/inference/predictor.py:
40-85).

`GraphedDecode` holds one key's static buffers (the input ids and mask,
the decode cache, the beam state) and its graphs, all in one memory pool:
- the prologue: the encoder, the cache's refill from its states
  (`DecoderStep.refill_cache`) and the beam state's reset;
- one decode step per window of the schedule (inference/beam.py): the
  bias width is static, so a window's step is one graph, replayed once a
  step.
A graph reads its buffers where they lie, so a batch is copied into the
static inputs and every other buffer is refilled in place; none is
allocated again while the key holds. The first time a part runs, it runs
uncaptured, on the capture stream, as a real part of the batch: that is
the warm-up a capture needs (the cuBLAS handle and workspace of the
stream, the sort's scratch, the kernels' libraries loaded). It is then
captured, and replayed from then on.

Without a stop, cur_len advances one a step, so the host knows each
window's replay count from the schedule (`beam.window_plan`); it reads the
stop flag a few replays late (`beam.StopFlags`), and the replays past a
stop change nothing. The host waits for the card once a batch, for the
beams, which come back through pinned buffers.

`GraphLaunches` (ops/launches.py) keeps the kernel wrappers' launch
counters equal to the kernels the card ran: what a capture adds is taken
back, and each replay adds the launches recorded at its capture.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.launches import GraphedPart, GraphLaunches  # noqa: F401
from .beam import (BeamState, StopFlags, beam_step, finalize, run_windows,
                   window_plan)


class GraphedDecode:
    """One key's static buffers and graphs (see the module's docstring).
    `run(input_ids, attention_mask)` decodes a batch of that key."""

    def __init__(self, module, step_model, num_beams: int, max_length: int,
                 attn_windows: Optional[Sequence[int]],
                 ids_shape: Tuple[int, ...], mask_shape: Tuple[int, ...]):
        device = module.decoder.word_embedding.device
        self.module, self.step_model = module, step_model
        self.cfg = module.decoder_config
        B, K, T = ids_shape[0], num_beams, max_length
        self.ids = torch.zeros(ids_shape, dtype=torch.long, device=device)
        self.mask = torch.zeros(mask_shape, dtype=torch.int32, device=device)
        self.ids_host = torch.empty(ids_shape, dtype=torch.long,
                                    pin_memory=True)
        self.mask_host = torch.empty(mask_shape, dtype=torch.int32,
                                     pin_memory=True)
        self.state = BeamState.allocate(B, K, T, device)
        self.cache = None
        self.plan = window_plan(T, attn_windows)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        # part ("prologue" or a window's index) -> its graph
        self.graphs: Dict[object, GraphedPart] = {}
        self.capture_ms = 0.0   # spent capturing, over the key's life
        self.seqs_host = torch.empty((B, K, T), dtype=torch.long,
                                     pin_memory=True)
        self.scores_host = torch.empty((B, K), pin_memory=True)
        self.cur_len_host = torch.empty((), dtype=torch.long,
                                        pin_memory=True)
        self.done_event = torch.cuda.Event()

    def _prologue(self) -> None:
        enc = self.module.encode(self.ids, self.mask)
        if self.cache is None:   # the key's first batch, uncaptured
            self.cache = self.step_model.init_cache(
                enc, self.mask, self.state.live_scores.shape[1],
                self.state.live_seqs.shape[2])
        else:
            self.step_model.refill_cache(self.cache, enc, self.mask)
        self.state.reset(self.cfg.bos_token_id, self.cfg.pad_token_id)

    def _step(self, i: int) -> None:
        beam_step(self.state,
                  lambda tokens, pos, bias: self.step_model(
                      tokens, self.cache, pos, bias),
                  self.plan[i], self.cfg.eos_token_id)

    def _run(self, part, fn: Callable[[], None]) -> None:
        """Replay `part`'s graph, or run `fn` uncaptured on the capture
        stream and capture it."""
        entry = self.graphs.get(part)
        if entry is None:
            if any(m.training for m in self.module.modules()):
                raise RuntimeError("a decode graph would capture a dropout "
                                   "draw: the module is in training mode")
            entry = self.graphs[part] = GraphedPart(self.pool, self.stream)
            entry(fn)
            self.capture_ms += entry.capture_ms
            return
        entry(fn)

    def run(self, input_ids: np.ndarray, attention_mask: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """(sequences (B, K, T), scores (B, K), steps, replays) of one
        batch; replays counts the decode steps the card ran, those past a
        stop included."""
        # the last batch ended in a wait for the card, so the pinned
        # inputs are free to refill
        self.ids_host.numpy()[...] = input_ids
        self.mask_host.numpy()[...] = attention_mask
        self.ids.copy_(self.ids_host, non_blocking=True)
        self.mask.copy_(self.mask_host, non_blocking=True)
        self._run("prologue", self._prologue)
        replays = run_windows(
            self.plan, lambda i: self._run(i, lambda: self._step(i)),
            StopFlags(self.state.done))
        seqs, scores = finalize(self.state)
        self.seqs_host.copy_(seqs, non_blocking=True)
        self.scores_host.copy_(scores, non_blocking=True)
        self.cur_len_host.copy_(self.state.cur_len, non_blocking=True)
        self.done_event.record()
        self.done_event.synchronize()
        return (self.seqs_host.numpy().copy(), self.scores_host.numpy().copy(),
                int(self.cur_len_host) - 1, replays)
