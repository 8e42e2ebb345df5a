#!/usr/bin/env python3
"""Where one optimizer step of the PyTorch port's RCR or template-based
training path, one batch of its serving path or of the template-free retro
serving path, or one search of its retrieval path, spends its time on one
CUDA GPU.

    python3 chip_profile.py [--path train|serving|retro|template|retrieval]
        [--out DIR]

`--path train` (the default) builds the same model, batch and step as chip_smoke.py's training phase
(SciBERT-base + bert_l6 at full width and depth, f32 parameters, bf16
compute, dropout 0.1, 4 micro-batches of 32 at L=512; the step's route,
on the card "cuda_graphs", is printed), runs two warm-up steps (the first
captures the graphs), then records one step with torch.profiler and
prints:
- the step's host-clock time, without and under the profiler, and the
  share of it in which the card ran at least one kernel (the rest is the
  host not keeping the card fed);
- device time by kind of kernel: the port's own four kernels by name,
  matrix products, the multi-tensor kernels (AdamW, the clip and the
  gradient averaging), and the remaining elementwise and reduction kernels;
- device time of the operators that only the plain decoder attention calls
  (batched products and softmax), read from the operator table;
- the twenty kernels with the most device time.
`--path serving` builds chip_smoke.py's serving model and batch (bf16
weights, 32 requests of L=512, beam 15, 16 decode positions); `--path
retro` chip_smoke.py's retro_tf serving model and test batch (bf16
weights, 32 products of L=512, beam 20 over 160 positions, 640 decode
rows). Each records one Generator.generate as it serves (the CUDA graphs
of the encoder and of each window's decode step, replayed) and one encoder
pass the same way, and prints: the tables above by kinds that part
softmax, the beam's sort, row gathers, matrix products and elementwise
copies; the port's kernel launches of one batch and the launches of a
decode step; capture ms and peak memory. Then it records the same batch
through the uncaptured device-state loop (`Generator.route =
"uncaptured"`), since the decode's own spans (utils/profiling.py: the
ancestor bias, the self-attention, the cross-attention and the decode's
products) open only as a graph is captured, not at its replay: device time
by operator and by those parts, and the largest casts, copies and
`index_select`s with their input shapes (none may be a cache's). Copied
into an older checkout, it profiles that checkout's Python loop in both
places (a checkout without the spans gives no parts).
`--path template` builds the benchmark's `retro_tb` model (RetroSyn_tb at
full width and depth, portbench/configs/retro_tb.json) and one step of its
traffic (4 x 32 at L=512 under bond masks), runs it on the uncaptured
route, where the attention's spans (`attention.mask_3d`: the fused route
under the packed bond mask; `attention.plain`: the plain path, which a
float32 model or an unaligned length takes) and the template heads'
(`template.head`) open, and prints the tables above and
each span's device time, forward and its backward (matched by autograd's
sequence numbers), as a share of the step's.
`--path retrieval` makes chip_smoke.py's two retrieval shapes and records
one FlatIndex.search of 8192 queries per shape and kernel layout: host
clock from numpy in to numpy out, and device time of the scan kernel, the
merge kernel and the copies to and from the card; then it times the
corpus-split layout at 1, 2 and 4 work items a multiprocessor (CUDA events,
median of 5), the choice behind ops/topk.py::ITEMS_PER_SM; last, at the
bench shape, the index in two corpus shards on the card: host clock beside
the shards searched one after another (the design before the shards were
queued together; five pairs, alternating which goes first), the host's
merge alone, and one sharded search's device time as above.
Every line names the card and its power limit. The tables also go to
DIR/profile_<path>.txt (default profile_out/). Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from textreact_tpu_torch.inference import Generator
from textreact_tpu_torch.models import build_model
from textreact_tpu_torch.ops import topk
from textreact_tpu_torch.retrieval import FlatIndex
from textreact_tpu_torch.tokenizers import get_tokenizers
from textreact_tpu_torch.train import (TrainState, make_accum_train_step,
                                       make_optimizer)

# kernel name fragments -> kind, first match wins
KINDS = (
    ("attention_fwd", "own: attention forward"),
    ("attention_bwd_dq", "own: attention backward, dQ pass"),
    ("attention_bwd_dkv", "own: attention backward, dK/dV pass"),
    ("residual_layernorm_fwd", "own: residual LayerNorm forward"),
    ("residual_layernorm_bwd", "own: residual LayerNorm backward"),
    ("multi_tensor_apply", "multi-tensor (AdamW, clip, gradient averaging)"),
    ("gemm", "matrix products"), ("nvjet", "matrix products"),
    ("cutlass", "matrix products"), ("xmma", "matrix products"),
    ("cublas", "matrix products"), ("gemv", "matrix products"),
    ("Memcpy", "copies"), ("Memset", "copies"),
)
DECODER_ATTENTION_OPS = ("aten::bmm", "aten::_softmax",
                         "aten::_softmax_backward_data")
# a serving batch's kernels by kind, first match wins: the row gathers (the
# beam's gathers, the embedding's lookup), softmax and log-softmax, the
# beam's sort, matrix products, and the elementwise copies (casts and
# contiguous copies)
DECODE_KINDS = (
    ("residual_layernorm_fwd", "own: residual LayerNorm forward"),
    ("attention_fwd", "own: attention forward"),
    ("gather_kernel", "row gathers (beam gathers)"),
    ("indexSelect", "row gathers (embedding lookup)"),
    ("SoftMax", "softmax and log-softmax"),
    ("softmax", "softmax and log-softmax"),
    ("ort", "beam top-k (sort)"),
    *((fragment, kind) for fragment, kind in KINDS
      if kind in ("matrix products", "copies")),
    ("copy", "elementwise copies (casts, contiguous copies)"),
)
# the decode's parts as the program's spans name them: device ms of the
# kernels that ran inside each range on the card's track
DECODE_RANGES = (("beam.ancestor_bias", "the ancestry bias, built once a "
                  "step"),
                 ("decode.self_attention", "self-attention: cache write, "
                  "products, scale and bias, softmax"),
                 ("decode.cross_attention", "cross-attention over the "
                  "example's encoder states"),
                 ("decode.products", "the decode attention's products, "
                  "bf16 operands read in place"))
# operators of a serving batch, device ms with their child kernels where
# marked: the casts, the contiguous copies, index_select, softmax, the
# matrix products (their own kernels), the beam's sort
DECODE_OPS = (("aten::_to_copy", "dtype casts (.float(), .to())", True),
              ("aten::clone", "contiguous copies", True),
              ("aten::index_select", "index_select", True),
              ("aten::embedding", "embedding lookups", True),
              ("aten::_softmax", "softmax", True),
              ("aten::_log_softmax", "log-softmax", True),
              ("aten::mm", "matrix products (mm)", False),
              ("aten::addmm", "matrix products (addmm)", False),
              ("aten::bmm", "matrix products (bmm)", False),
              ("aten::sort", "beam top-k (sort)", True))
# operators whose largest calls are listed with their input shapes
COPY_OPS = ("aten::_to_copy", "aten::clone", "aten::contiguous",
            "aten::index_select")


def device_ms_in_ranges(prof, names) -> dict:
    """{range name: (device ms of the kernels and copies inside the name's
    ranges on the card's track, ranges)}. A range's own span on that track
    runs from its first kernel to its last, the host's gaps between them
    included, so the kernels inside it are summed instead."""
    ranges = {name: [] for name in names}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.name in ranges):
            ranges[ev.name].append((ev.time_range.start, ev.time_range.end))
    kernels = sorted((start, end) for _, start, end in cs.device_events(prof))
    out = {}
    for name, spans in ranges.items():
        us, i = 0.0, 0
        for lo, hi in sorted(spans):
            while i < len(kernels) and kernels[i][1] <= lo:
                i += 1
            j = i
            while j < len(kernels) and kernels[j][0] < hi:
                us += max(0.0, min(hi, kernels[j][1])
                          - max(lo, kernels[j][0]))
                j += 1
        out[name] = (us / 1e3, len(spans))
    return out


def kind_of(name: str, kinds=KINDS) -> str:
    for fragment, kind in kinds:
        if fragment in name:
            return kind
    return "elementwise, reductions, gathers"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def profile_retrieval(card: str, say) -> None:
    k = cs.TOPK_K
    for shape in ("bench", "rcr"):
        corpus, queries, banned = cs.retrieval_data(shape)
        index = FlatIndex(corpus)
        for resident, name in cs.TOPK_LAYOUTS.items():
            index.corpus_resident = resident
            plain_ms = cs.wall_ms(
                lambda: index.search(queries, k=k, banned=banned))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                index.search(queries, k=k, banned=banned)
                wall_ms = (time.perf_counter() - t0) * 1e3
            by_kernel = defaultdict(float)
            events = cs.device_events(prof)
            for kernel, start, end in events:
                by_kernel[kernel] += end - start
            if not by_kernel:
                raise SystemExit("chip_profile: the profiler recorded no "
                                 "device time")
            busy = busy_us([(a, b) for _, a, b in events])
            say(f"[profile] {shape} {name}: corpus {corpus.shape}, "
                f"{len(queries)} queries, k={k}: FlatIndex.search "
                f"{plain_ms:.2f} ms host clock without the profiler (median "
                f"of 5), {wall_ms:.2f} ms under it; the card ran something "
                f"for {busy / 1e3:.2f} ms ({busy / (plain_ms * 1e3):.1%} of "
                f"the search without the profiler); on {card}")
            for kernel, us in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
                say(f"  {us / 1e3:9.3f} ms {us / busy:6.1%}  {kernel[:110]}")
            # the profiler has lost launches: say so where it lost the scan's
            scans = sum("topk_scan" in kernel for kernel, _, _ in events)
            if scans != 1:
                say(f"  the profiler saw {scans} scan launches of 1: this "
                    f"breakdown is not complete")
        # the corpus-split layout's slab count: work items per multiprocessor
        q_dev = torch.from_numpy(queries).cuda()
        b_dev = None if banned is None else torch.from_numpy(banned).cuda()
        default = topk.ITEMS_PER_SM
        try:
            for items in (1, 2, 4):
                topk.ITEMS_PER_SM = items
                slabs = topk.split_slabs(len(queries), len(corpus),
                                         q_dev.device)
                ms = cs.time_ms(lambda: topk.exact_topk_l2(
                    q_dev, index.corpus, index.norms, b_dev, k=k,
                    corpus_resident=True), reps=5)
                say(f"[profile] {shape} corpus-split at {items} work items "
                    f"an SM ({slabs} slabs): {ms:.3f} ms device time"
                    f"{' (the default)' if items == default else ''}; on "
                    f"{card}")
        finally:
            topk.ITEMS_PER_SM = default
        del index, q_dev, b_dev
        torch.cuda.empty_cache()
        if shape == "bench":
            profile_sharded_retrieval(card, say, corpus, queries)


def profile_sharded_retrieval(card: str, say, corpus, queries) -> None:
    """The bench corpus in two shards on the card (chip_smoke.py's leg C):
    where its numpy-in to numpy-out time goes."""
    from textreact_tpu_torch.retrieval.engine import BIG, merge_topk
    k = cs.TOPK_K
    index = FlatIndex(corpus, devices=["cuda:0", "cuda:0"])

    def shards_in_turn():
        parts = []
        for first, shard in index.shards:
            vals, idx = shard.search(queries, k=k)
            parts.append((torch.from_numpy(vals.copy()), torch.from_numpy(
                np.where(idx >= BIG, idx, idx + first).astype(np.int32))))
        return merge_topk(parts, k), parts

    (ref_v, ref_i), parts = shards_in_turn()
    got = index.search(queries, k=k)
    if not (np.array_equal(got[0], ref_v.numpy())
            and np.array_equal(got[1], ref_i.numpy())):
        raise SystemExit("chip_profile: the sharded search and the shards "
                         "in turn differ")
    together, in_turn = [], []
    for rep in range(5):
        order = ((together, lambda: index.search(queries, k=k)),
                 (in_turn, shards_in_turn))
        for times, fn in (order if rep % 2 == 0 else order[::-1]):
            times.append(cs.wall_ms(fn, reps=1))
    merge_ms = cs.wall_ms(lambda: merge_topk(parts, k))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        index.search(queries, k=k)
    events = cs.device_events(prof)
    by_kernel = defaultdict(float)
    for kernel, start, end in events:
        by_kernel[kernel] += end - start
    busy = busy_us([(a, b) for _, a, b in events])
    say(f"[profile] bench, 2 shards on cuda:0: FlatIndex.search host clock "
        f"{sorted(together)} ms (shards queued together) and "
        f"{sorted(in_turn)} ms (shards in turn), five pairs; the host's "
        f"merge of the two lists alone {merge_ms:.2f} ms (median of 5); "
        f"the card ran something for {busy / 1e3:.2f} ms of one search; on "
        f"{card}")
    for kernel, us in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        say(f"  {us / 1e3:9.3f} ms {us / max(busy, 1e-9):6.1%}  "
            f"{kernel[:110]}")
    del index
    torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--path", choices=("train", "serving", "retrieval",
                                           "retro", "template"),
                        default="train")
    parser.add_argument("--out", default="profile_out")
    args = parser.parse_args()
    card = cs.phase_device()
    cs.phase_build()
    lines = []

    def say(msg: str) -> None:
        cs.log(msg)
        lines.append(msg)

    if args.path == "retrieval":
        profile_retrieval(card, say)
    elif args.path == "serving":
        profile_serving(card, say)
    elif args.path == "retro":
        profile_retro(card, say)
    elif args.path == "template":
        profile_template(card, say)
    else:
        profile_train(card, say)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"profile_{args.path}.txt").write_text("\n".join(lines) + "\n")
    return 0


def profile_train(card: str, say) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        vocab = Path(tmp) / "vocab.txt"
        cs.write_text_vocab(vocab)
        cfg = cs.train_config(vocab)
        enc_tok, dec_tok = get_tokenizers(cfg)
        module, _, _ = build_model(cfg, enc_tok, dec_tok,
                                   torch.Generator().manual_seed(0))
        batch = cs.make_train_batch(cfg, enc_tok, dec_tok, cfg.batch_size)
    micro = cs.as_microbatches(batch, cs.MICRO_BATCHES)
    optimizer = make_optimizer(cfg, 100, module.named_parameters())
    state = TrainState.create(module, optimizer)
    step = make_accum_train_step(module, cfg, optimizer, dec_tok.pad_token_id)
    weights = np.ones(cs.MICRO_BATCHES, np.float32)
    box = {"state": state}

    def one_step():
        box["state"], box["metrics"] = step(box["state"], micro, weights,
                                            cfg.seed)

    for _ in range(2):
        one_step()
    plain_ms, wall_ms, prof = profile_call(one_step)
    metrics = box["metrics"]
    where = (f"{cs.MICRO_BATCHES} x {cs.B} examples at L={cs.L}, bf16 "
             f"compute, f32 parameters, dropout {cs.DROPOUT_P}, train step "
             f"route {step.route}, on {card}")
    report(prof, f"one optimizer step (loss "
           f"{float(metrics['train_loss']):.4f})", plain_ms, wall_ms, where,
           say)
    ops = {e.key: e for e in prof.key_averages()}
    dec_us = sum(ops[name].self_device_time_total
                 for name in DECODER_ATTENTION_OPS if name in ops)
    say(f"[profile] of which plain decoder attention (operators "
        f"{', '.join(DECODER_ATTENTION_OPS)}, which nothing else on this "
        f"path calls): {dec_us / 1e3:.2f} ms")


def report(prof, what: str, plain_ms: float, wall_ms: float, where: str,
           say, top: int = 20, kinds=KINDS) -> tuple:
    """The tables of one profiled call: host clock, the card's busy share,
    device time by kind of kernel and by kernel. Returns (device us,
    kernels and copies)."""
    by_kind, by_kernel, intervals = defaultdict(float), defaultdict(float), []
    calls = defaultdict(int)
    for name, start, end in cs.device_events(prof):
        by_kind[kind_of(name, kinds)] += end - start
        by_kernel[name] += end - start
        calls[name] += 1
        intervals.append((start, end))
    device_us = sum(by_kind.values())
    if not device_us > 0.0:
        raise SystemExit("chip_profile: the profiler recorded no device time")
    busy = busy_us(intervals)
    say(f"[profile] {what}: {plain_ms:.1f} ms host clock without the "
        f"profiler (median of 3), {wall_ms:.1f} ms under it (it slows the "
        f"host); {where}")
    say(f"[profile] device time {device_us / 1e3:.1f} ms in "
        f"{len(intervals)} kernels and copies; the card ran something for "
        f"{busy / 1e3:.1f} ms: {busy / (plain_ms * 1e3):.1%} of the call "
        f"without the profiler (idle {1 - busy / (plain_ms * 1e3):.1%}), "
        f"{busy / (wall_ms * 1e3):.1%} of the profiled call")
    say("[profile] device time by kind:")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        say(f"  {us / 1e3:9.2f} ms {us / device_us:6.1%}  {kind}")
    say("[profile] kernels with the most device time:")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]:
        say(f"  {us / 1e3:9.2f} ms {us / device_us:6.1%} {calls[name]:6d} "
            f"calls  {name[:110]}")
    return device_us, len(intervals)


def profile_call(fn, record_shapes: bool = False):
    """(median host ms of 3 calls, host ms under the profiler, profile)."""
    plain_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return sorted(plain_ms)[1], wall_ms, prof


def profile_template(card: str, say) -> None:
    """One optimizer step of the template cell's traffic (portbench's
    `retro_tb.train`: 4 x 32 at L=512 under (L, L) bond masks, MLM), at
    full width and depth, on the uncaptured route, where the attention's
    spans (the packed-mask route's, the plain path's) and the template
    heads' open (on the graphed route they mark the capture's host side
    only)."""
    from portbench import program, traffic, traffic_template
    from portbench.kinds import train_template
    config = program.load_config("retro_tb")
    cfg = train_template.experiment(config, "retro_tb", 0)
    ids = config["encoder_ids"]
    module, _, _ = build_model(
        cfg, program.Vocab(ids["vocab_size"], ids["pad"]),
        train_template.Tables(config["num_atom_templates"],
                              config["num_bond_templates"]),
        torch.Generator().manual_seed(0))
    mix = dict(traffic.load("train_templates"), pool_steps=1)
    micro = traffic_template.pool(mix, config, 0)[0]
    optimizer = make_optimizer(cfg, 100, module.named_parameters())
    state = TrainState.create(module, optimizer)
    step = make_accum_train_step(module, cfg, optimizer, 0)
    step.route = "uncaptured"
    weights = np.ones(mix["micro_batches"], np.float32)
    box = {"state": state}

    def one_step():
        box["state"], box["metrics"] = step(box["state"], micro, weights,
                                            cfg.seed)

    for _ in range(2):
        one_step()
    plain_ms, wall_ms, prof = profile_call(one_step)
    where = (f"{mix['micro_batches']} x {mix['micro_batch_size']} examples "
             f"at L={mix['prompt']['length']} under bond masks, bf16 "
             f"compute, f32 parameters, dropout 0.1, uncaptured route, on "
             f"{card}")
    device_us, _ = report(prof, f"one template optimizer step (loss "
                          f"{float(box['metrics']['train_loss']):.4f})",
                          plain_ms, wall_ms, where, say)
    split = span_split(prof, ("attention.mask_3d", "attention.plain",
                              "template.head"))
    for name, (fwd_us, bwd_us, count) in split.items():
        say(f"[profile] under {name} ({count} ranges): forward "
            f"{fwd_us / 1e3:.2f} ms, its backward {bwd_us / 1e3:.2f} ms, "
            f"together {(fwd_us + bwd_us) / device_us:.1%} of the step's "
            f"device time")


def span_split(prof, names) -> dict:
    """{span name: (device us of the kernels launched inside its ranges,
    device us of the autograd backward of the operators that ran inside
    them, ranges)}. The backward is matched by sequence number: autograd
    gives a backward function the number of the forward operator that made
    it."""
    cpu = torch.autograd.DeviceType.CPU
    out = {}
    for name in names:
        ranges = [ev for ev in prof.events()
                  if ev.device_type == cpu and ev.name == name]
        seqs, stack = set(), list(ranges)
        while stack:
            ev = stack.pop()
            for child in ev.cpu_children:
                if child.sequence_nr >= 0:
                    seqs.add(child.sequence_nr)
                stack.append(child)
        bwd = sum(ev.device_time_total for ev in prof.events()
                  if ev.name.startswith("autograd::engine::evaluate_function")
                  and ev.sequence_nr in seqs)
        out[name] = (sum(ev.device_time_total for ev in ranges), bwd,
                     len(ranges))
    return out


def profile_serving(card: str, say) -> None:
    """One serving batch of the RCR recipe (chip_smoke.py's serving phase)."""
    with tempfile.TemporaryDirectory() as tmp:
        vocab = Path(tmp) / "vocab.txt"
        cs.write_text_vocab(vocab)
        cfg = cs.base_config(vocab, param_dtype="bfloat16")
        enc_tok, dec_tok = get_tokenizers(cfg)
        module, _, _ = build_model(cfg, enc_tok, dec_tok,
                                   torch.Generator().manual_seed(0))
        batch = cs.make_requests(enc_tok, cs.B, cs.L)
    profile_generate(card, say, module, batch, "serving", cs.BEAMS,
                     cs.DEC_LEN, top=12)


def profile_retro(card: str, say) -> None:
    """One serving batch of the template-free retro recipe (chip_smoke.py's
    retro_tf phase: 32 test products of the template fixture, bf16
    weights, beam 20 over 160 positions)."""
    with tempfile.TemporaryDirectory() as tmp:
        vocab = Path(tmp) / "vocab.txt"
        cs.write_text_vocab(vocab)
        data = Path(tmp) / "template_data"
        cs.write_template_fixture(data)
        cfg = cs.retro_config(data, vocab, param_dtype="bfloat16")
        enc_tok, dec_tok = get_tokenizers(cfg)
        module, _, _ = build_model(cfg, enc_tok, dec_tok,
                                   torch.Generator().manual_seed(0))
        batch = cs.retro_batch(cfg, enc_tok, dec_tok, "test", cs.B).arrays
    profile_generate(card, say, module, batch, "retro serving",
                     cs.RETRO_BEAMS, cs.RETRO_DEC_LEN, top=15)


def profile_generate(card: str, say, module, batch: dict, what: str,
                     beams: int, dec_len: int, top: int) -> None:
    """One Generator.generate as it serves (the graphed route; in a
    checkout from before the graphs, its Python loop): host clock, the
    card's busy time and idle share, device time by kind of kernel, the
    port's kernel launches, the launches of a decode step (the batch's
    kernels less the encoder pass's, over the steps the card ran), capture
    ms and peak memory. Then the same batch through the uncaptured loop,
    where the decode's part spans open at every step, as they do not at a
    graph's replay: device time by part of the decode and by operator, and
    the largest casts and copies with their shapes."""
    gen = Generator(module, num_beams=beams, max_length=dec_len)
    route = getattr(gen, "route", "python loop (a checkout before graphs)")
    try:
        from textreact_tpu_torch.inference.beam import _plan_windows
        windows = _plan_windows(dec_len, gen.attn_windows)
    except ImportError:   # a checkout from before the windows
        windows = "none: per-row cache, reordered"
    dev = module.decoder.word_embedding.device
    ids = torch.as_tensor(batch["input_ids"], dtype=torch.long, device=dev)
    mask = torch.as_tensor(batch["attention_mask"], device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen.generate(batch)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    capture_ms = getattr(gen, "last_capture_ms", None)
    cs.reset_counts()
    gen.generate(batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cs.read_counts().items() if v}
    steps = gen.last_steps
    replays = getattr(gen, "last_replays", steps)
    where = (f"B={cs.B} L={cs.L} beam {beams} dec {dec_len} ({steps} "
             f"decode steps in {replays} replays of {cs.B * beams} rows, "
             f"windows {windows}), bf16 weights, route {route}, on {card}")
    plain_ms, wall_ms, prof = profile_call(lambda: gen.generate(batch))
    device_us, kernels = report(prof, f"one {what} batch ({steps} decode "
                                f"steps), as it serves", plain_ms, wall_ms,
                                where, say, top=top, kinds=DECODE_KINDS)
    say(f"[profile] the port's kernels launched by one batch: {launches}")
    say(f"[profile] capture {fmt(capture_ms)} ms in the first batch; peak "
        f"device memory {peak_gb:.2f} GB over it")

    def encode():
        with torch.inference_mode():
            module.encode(ids, mask)

    enc_plain, enc_wall, enc_prof = profile_call(encode)
    _, enc_kernels = report(enc_prof, "the encoder alone (uncaptured)",
                            enc_plain, enc_wall, where, say, top=8,
                            kinds=DECODE_KINDS)
    say(f"[profile] launches a decode step: ({kernels} - {enc_kernels} of "
        f"the encoder) / {replays} steps the card ran = "
        f"{(kernels - enc_kernels) / replays:.1f} kernels and copies")

    ref = Generator(module, num_beams=beams, max_length=dec_len)
    ref.route = "uncaptured"   # no attribute of a checkout before graphs
    ref.generate(batch)
    plain_ms, wall_ms, prof = profile_call(lambda: ref.generate(batch),
                                           record_shapes=True)
    device_us, _ = report(prof, f"the same {what} batch through the "
                          f"uncaptured loop, for the decode's parts",
                          plain_ms, wall_ms, where, say, top=top,
                          kinds=DECODE_KINDS)
    ops = {e.key: e for e in prof.key_averages()}
    say("[profile] uncaptured loop: device time by part of the decode (the "
        "kernels inside its ranges):")
    for name, (ms, n) in device_ms_in_ranges(
            prof, [name for name, _ in DECODE_RANGES]).items():
        label = dict(DECODE_RANGES)[name]
        say(f"  {ms:9.2f} ms {ms * 1e3 / max(device_us, 1e-9):6.1%} {n:7d} "
            f"ranges {name}: {label}" if n else f"  {name}: not in the "
            f"trace")
    say("[profile] uncaptured loop: device time by operator (with the "
        "kernels it launched where marked 'incl.'):")
    for name, label, inclusive in DECODE_OPS:
        if name not in ops:
            say(f"  {name}: not in the trace")
            continue
        e = ops[name]
        us = e.device_time_total if inclusive else e.self_device_time_total
        say(f"  {us / 1e3:9.2f} ms {us / max(device_us, 1e-9):6.1%} "
            f"{e.count:7d} calls  {name} {'incl. ' if inclusive else ''}"
            f"{label}")
    say("[profile] uncaptured loop: the largest casts, copies and "
        "index_selects by input shape (device ms incl. their kernels):")
    by_shape = [e for e in prof.key_averages(group_by_input_shape=True)
                if e.key in COPY_OPS]
    for e in sorted(by_shape, key=lambda e: -e.device_time_total)[:8]:
        say(f"  {e.device_time_total / 1e3:9.2f} ms {e.count:7d} calls  "
            f"{e.key} {e.input_shapes}")


def fmt(ms) -> str:
    return "not measured (no capture)" if ms is None else f"{ms:.1f}"


if __name__ == "__main__":
    sys.exit(main())
