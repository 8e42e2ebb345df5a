"""Serving cells: `Generator.generate` on the graphed route, one client in a
closed loop over a pool of batches, each call timed from its arrays to its
beams and scores on the host as numpy.

Set-up builds the model with its weights in the serving dtype, loads the
benchmark's weights and serves `warmup_batches` of the pool: the first
captures the key's graphs (the prologue and one decode step a window of
the schedule), so nothing is captured inside the window.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import check, flops, program, traffic, weights
from ..reference import encdec


class Cell:
    unit = "batches"

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
        from textreact_tpu_torch.inference import Generator
        self.exp = program.experiment(cfg, ctx.config_name, "serve", ctx.seed)
        self.module, _, _ = program.build(cfg, self.exp, dev)
        self.spec = weights.specs(cfg["encoder"], cfg["decoder"], mlm=False)
        weights.load_into(self.module, self._weights())
        self.gen = Generator(self.module, cfg["num_beams"],
                             cfg["serve_max_dec_length"],
                             attn_windows=cfg["attn_windows"])
        if dev.type == "cuda" and self.gen.route != "cuda_graphs":
            raise RuntimeError(f"the decode runs {self.gen.route!r} on the "
                               "card, not its graphed route")
        self.pool = traffic.serve_pool(mix, cfg, ctx.seed)
        self.served: List[tuple] = []   # (pool index, seqs, scores, steps)
        self.latency_ms: List[float] = []
        self.done = 0
        for _ in range(mix["warmup_batches"]):
            self.run_unit()
        self.served.clear()
        self.latency_ms.clear()

    def _weights(self, dtype=None):
        cfg = self.ctx.cfg
        return weights.make(self.spec, self.ctx.seed,
                            cfg["encoder"]["initializer_range"],
                            dtype or program.dtype(cfg["serve_dtype"]),
                            self.ctx.device)

    # --- the window's work ---------------------------------------------
    def run_unit(self) -> None:
        i = self.done % len(self.pool)
        t0 = time.perf_counter()
        seqs, scores = self.gen.generate(self.pool[i])
        self.latency_ms.append((time.perf_counter() - t0) * 1e3)
        self.served.append((i, seqs, scores, self.gen.last_steps))
        self.done += 1

    def sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def end_to_end(self, units: int, window_s: float) -> Dict[str, tuple]:
        B = self.ctx.mix["batch_size"]
        out = {self.ctx.mix["rate_metric"]: (units * B / window_s,
                                             "requests/s")}
        if self.ctx.mix["latency_tail"]:
            out["serve_batch_p95_ms"] = (
                float(np.percentile(self.latency_ms, 95)), "ms")
            self.ctx.log(f"serve_batch_p95_ms over {len(self.latency_ms)} "
                         f"batches, median "
                         f"{float(np.median(self.latency_ms))!r} ms")
        return out

    def slice_facts(self, first: int, count: int) -> dict:
        """Model FLOPs of `count` batches from batch `first` (counted from
        the start of the warm-up)."""
        cfg = self.ctx.cfg
        k = first - self.ctx.mix["warmup_batches"]
        total = 0.0
        for i, _, _, steps in self.served[k:k + count]:
            total += flops.serve_batch_flops(
                self.pool[i]["attention_mask"], cfg["num_beams"], steps,
                cfg["encoder"], cfg["decoder"])
        return {"model_flops": total, "bound_s": {}}

    # --- correctness -----------------------------------------------------
    def free(self) -> None:
        del self.gen, self.module

    def sample(self) -> List[tuple]:
        """(pool index, row, seqs, scores, steps) of the checked requests."""
        eos = self.ctx.cfg["decoder_ids"]["eos"]
        B = self.ctx.mix["batch_size"]
        served = [(j, r) for j in range(len(self.served)) for r in range(B)]
        sizes = []
        for j, r in served:
            _, seqs, _, steps = self.served[j]
            sizes.append(sum(check.served_end(s, steps, eos)
                             for s in seqs[r]))
        picks = check.pick_requests(len(served),
                                    self.ctx.mix["checked_requests"],
                                    int(np.argmax(sizes)), self.ctx.seed)
        out = []
        for p in picks:
            j, r = served[p]
            i, seqs, scores, steps = self.served[j]
            out.append((i, r, seqs[r], scores[r], steps))
        return out

    def check(self) -> Dict[str, tuple]:
        numbers = serve_numbers(self.ctx, self.pool, self.sample(),
                                self._weights(torch.float32))
        return {k: (v, "") for k, v in numbers.items()}


def serve_numbers(ctx, pool, sample, params, control: bool = False,
                  detail: list = None) -> Dict[str, float]:
    """The widest score and selection gaps over the sampled requests, and
    the median request's score and selection gaps, judged by the float32
    reference;
    with `control`, the gaps of the float8 reference put in the served
    model's place (its scores of the same tokens, its choice at the last
    step). `detail`, a list, gets each request's served-minus-reference
    score of every beam and its selection gap."""
    cfg, dev = ctx.cfg, ctx.device
    encdec.strict_f32()
    eos = cfg["decoder_ids"]["eos"]
    ref = encdec.EncDec(params, cfg["encoder"], cfg["decoder"],
                        encdec.Products("f32"))
    low = encdec.EncDec(params, cfg["encoder"], cfg["decoder"],
                        encdec.Products("fp8")) if control else None
    gaps, selects = [], []
    with torch.no_grad():
        for i, r, seqs, scores, steps in sample:
            ids = torch.as_tensor(pool[i]["input_ids"][r:r + 1],
                                  dtype=torch.long, device=dev)
            mask = torch.as_tensor(pool[i]["attention_mask"][r:r + 1],
                                   dtype=torch.long, device=dev)
            lp = check.beam_logp(ref, ref.encode(ids, mask), mask, seqs)
            if control:
                lp_low = check.beam_logp(low, low.encode(ids, mask), mask,
                                         seqs)
                scores = _scores(lp_low, seqs, steps, eos)
            s_gap, l_gap, ref_scores = check.request_numbers(
                lp, seqs, scores, steps, eos,
                chooser=lp_low if control else None)
            if detail is not None:
                detail.append({"score": (scores - ref_scores).tolist(),
                               "select": l_gap})
            gaps.append(s_gap)
            selects.append(l_gap)
    return {"score_gap": max(gaps),
            "score_median": float(np.median(gaps)),
            "select_gap": max(selects),
            "select_median": float(np.median(selects))}


def _scores(lp: torch.Tensor, seqs: np.ndarray, steps: int,
            eos: int) -> np.ndarray:
    x = lp.double().cpu().numpy()
    out = np.zeros(seqs.shape[0])
    for k in range(seqs.shape[0]):
        t = np.arange(1, check.served_end(seqs[k], steps, eos) + 1)
        out[k] = x[k, t - 1, seqs[k, t]].sum()
    return out
