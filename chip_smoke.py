#!/usr/bin/env python3
"""Drive the PyTorch port's RCR serving, training, retrieval, causal-decoder
and command-line paths, its template-based and template-free
retrosynthesis paths and its offline curation, once on one CUDA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build: compile every CUDA kernel from textreact_tpu_torch/csrc, one nvcc
   process per source, and the two C++ host libraries (tokenizer,
   chemistry) with g++, all started together;
3. kernels: each of the four encoder kernels (attention forward and
   backward, residual-LayerNorm forward and backward) against its plain PyTorch
   version on the card, at the shapes the paths give it, in float32 and
   bfloat16, without dropout and at p = 0.1 with the kernel's own keep mask
   exported and fed to the plain version, each with a stated tolerance; the
   bfloat16 attention kernels (at head dims 32, 64, 128 and at 96 and 48,
   which run the next width's kernels at their own head dim, two lengths, a
   mask that is no prefix, causal and not) also against the plain
   statement of their own rounding points at a tenth of that tolerance,
   every element (the
   backward against the statement fed the kernel's forward output; at the
   main shape the dk element furthest from the statement fed its own output
   taken apart: its dS terms before and after rounding in the kernel's
   order and the statement's), and their dropout bits
   against the exported mask to the bit; the mask's statistics; all timed (CUDA events, median of 20 calls queued
   while the card is held busy, so device time) beside the least time the
   card could take and, for attention, beside
   F.scaled_dot_product_attention (timed only, used nowhere in the port);
   the causal attention forward and backward the same way (no dropout) at
   L=512 and L=128, beside SDPA under a boolean mask that joins the causal
   and the key mask; the routes of the shapes past the recipes' the same
   way: attention at 16 heads of 96 and causal attention at 8 (the D=128
   kernels reading and writing 96 columns, no copies; each also equal to
   the bit to the same kernels on inputs zero-padded to 128 beforehand,
   both timed), residual LN at rows of 2048 (the wide route; the rows of
   1536 that step 8 gives it; 1152, 8192 at a few rows); then both layouts
   of the exact top-k L2 search at small shapes (ragged sizes, k from 1 to
   1024: past 128 work items of 64 queries that merge runs, the lists in
   shared memory up to 339 and in device memory past it; fewer rows than
   k, ties across tiles and slabs, banned ids, negative counts, d from 128
   to 2048) against the plain version on the card and the float64 numpy
   oracle on the host, equal to the bit; the grouped decode
   self-attention kernel at the retro and RCR serving shapes against its
   plain version and float64, timed at three lengths of each window
   beside its bound, the plain version and SDPA
   (`phase_decode_attention`; its launches on the main path are those of
   the serving phases);
4. serving path: the RCR recipe's serving configuration at full width
   (SciBERT-base encoder, 12 x 768, L=512, bf16; bert_l6 decoder, beam 15,
   16 decode positions; batch 32) with random weights from a seeded
   torch.Generator: tokenize 32 requests, Generator.generate (the
   row-stable grouped beam cache under the ancestry bias, one window of
   16; the encoder and the decode steps captured as CUDA graphs at the
   first batch and replayed), predictions_from_beams; checks shapes,
   finite non-increasing scores, the forward kernels' launch counts (a
   replay counts its graph's kernels), and the beams, scores and steps
   equal to the bit to the uncaptured device-state loop's on the same
   batch; route, steps, replays, capture ms, ms a batch and a step, the
   card's busy ms and idle share, peak memory; then the same batch's
   encoder states with the kernels and with the plain functions, within a
   stated bound;
5. training path: the RCR recipe's training step at full width and depth
   (f32 parameters, bf16 compute, MLM head, dropout 0.1, clip 5, AdamW,
   cosine schedule): 128 tokenized, span-masked, collated examples run as 4
   micro-batches of 32 at L=512 for 3 optimizer steps on each of the
   step's two routes from one snapshot of weights and moments: the CUDA
   graphs (train/graphs.py: each part run once uncaptured, captured, then
   replayed) and the same parts uncaptured; checks finite metrics, a
   falling loss, changed parameters, the exact launch counts of all four
   kernels on both routes (the graphed one's go into the kernels line),
   and every metric, parameter and moment of the two routes equal to the
   bit (both under torch's deterministic algorithms, without which the
   embedding backward's atomics part two runs of one route); each route's
   host ms, the card's span (CUDA events), busy ms and
   idle share (profiler), the host's launch calls a step, capture ms per
   key and peak memory, printed as the `train` line; then the eval step
   (its forward, top 1) on its two routes over the four micro-batches:
   the graphed one (train/graphs.py `EvalGraphs`: the key captured at its
   first batch, replayed after) and the uncaptured one, every output of
   every batch equal to the bit, exact launches on both, each route's host
   ms a batch, the card's span, busy ms and idle share, host launch calls,
   keys, capture ms and peak memory (the `eval` line's "rcr"); a weight-0
   micro-batch changes nothing;
6. training, kernels against plain functions: one micro-batch's loss and
   every gradient in float32 without dropout, within a stated bound;
7. retrieval path at full size through FlatIndex.search, data made from a
   seed with numpy: the bench shape (200,000 binary fingerprints of 1024
   bits) and the RCR shape (700,000 reaction count fingerprints of 2048,
   2% duplicated rows, queries taken from the corpus with their own ids
   banned), 8192 queries, k = 20, each layout: equal to the plain version
   on the card (first 256 queries) and to the numpy oracle (first 64), then
   timed (device ms, TOP/s and the share of the operations bound, the scan
   and the merge apart by the profiler, and host ms from numpy in to numpy
   out) beside the plain version and torch._int_mm + torch.topk (timed
   only); the scan's registers, spills and shared memory from the build;
8. the retrieval CLI, in-process on the card, on fixture CSVs written at
   run time, with --check_parity; the three neighbour files read back;
   then the routes of the shapes past the recipes', through the entry
   points, each with exact launch counts: one training step of a model of
   2 + 2 layers of 1536 in 16 heads of 96 (attention below the kernels'
   width, wide LN), then its loss and gradients in f32 against the plain
   functions, a training pass of two causal blocks with heads of 96,
   FlatIndex.search at k = 256 in both layouts on the bench data (equal to
   the plain version and the numpy oracle, timed; the scan's plan, and
   k = 1024 checked and timed beside the library);
9. causal path: a stack of six TransformerBlock(causal=True) with bert_l6's
   geometry and cross-attention over encoder states of L=512, B=32 at L=512
   and L=128, no self bias and a ragged key mask: forward in eval mode and
   forward + backward in training mode (hidden dropout 0.1, no attention
   dropout), launch counts of the causal kernels asserted; kernels against
   plain functions (bf16 forward; f32 forward and every gradient at p=0);
   an unaligned length (160) launches no causal kernel;
10. runtime: python -m textreact_tpu_torch's main, in-process on the card, on
   the CSVs of phase 8, a corpus written at run time and the neighbour files
   that phase 8's retrieval CLI wrote: full width and depth, bf16, MLM,
   dropout 0.1, batch 32 x accumulation 4, 512 training reactions, 2 epochs,
   --do_train --do_valid --do_test, beam 15; a falling loss, published
   checkpoints, two prediction files, kernel launches that match the steps
   run, the trainer's train step route (cuda_graphs) printed, each
   epoch's validation and --do_valid's on the eval step's graphed route
   (metrics.jsonl: route, keys, replays, seconds); then the same command
   with one more epoch resumes;
11. the pretrained start: two HF checkpoint directories written from a
   seed (SciBERT-base as model.safetensors; a 6-layer BERT of vocab 300
   with the MaskedLM head as pytorch_model.bin with the `bert.` prefix),
   then `python -m textreact_tpu_torch` in-process with scripts/train_RCR.sh's
   flags and `--encoder <dir> --encoder_pretrained --decoder <dir>
   --decoder_pretrained` on phase 10's data: before the first step every
   imported parameter equal to its file's tensor to the bit, the rest
   (cross-attention, MLM head, rows past the file's table) to the seeded
   initialisation, nothing unread but the poolers; one epoch of 4 x 32 and
   a validation pass with exact kernel launch counts; then every example of
   the run built through the C++ tokenizer equal to the Python route's,
   the C++ fingerprints and canonical SMILES equal to the Python route's on
   the run's reactions and molecules (and on non-ASCII strings), both
   routes timed;
12. template-based retrosynthesis (scripts/parity_run.py's RetroSyn_tb:
   SciBERT-base encoder at full width and depth over the joint SMILES +
   text vocabulary, L=512, bf16, dropout 0.1, lr 2e-4, 4 x 32) on synthetic
   drug and ester products of 21-50 heavy atoms with 400 atom and 60 bond
   template classes and neighbour text filling L: three optimizer steps
   under the bond mask (a falling loss, changed parameters, 96 + 96
   residual-LN launches a step and no attention launch), one step without
   it (48 + 48 attention launches); the eval step at top 500 edits under
   the bond mask on its two routes as in phase 5 (the `eval` line's
   "template"), and
   `device_topk_edits` on the card equal to `rank_edits` on the host on the
   same probabilities, ties included; the ester decode through the own
   template engine gives the gold reactants; the loader's bond masks, the
   step (host clock and the card's busy time) and one layer's plain
   bond-masked attention beside the fused kernel and SDPA, timed; kernels
   against plain functions in f32 with and without the bond mask; then
   `python -m textreact_tpu_torch --task retro --template_based
   --unattend_nonbonds` in-process (train, validate, test with the decode;
   the validations and test passes on the eval step's graphed route, their
   keys and replays printed);
12b. template-free retrosynthesis (scripts/torch_port/train_RetroSyn_tf.sh:
   the same encoder over the text tokenizer, bert_l6 over the SMILES
   vocabulary at 160 decoder positions, MLM; with --shuffle_smiles) on phase
   12's products: three optimizer steps of 4 x 32 with the decoder at 160
   (a falling loss, changed parameters, 48 + 48 attention and 168 + 168
   residual-LN launches a step: 96 at 16384 rows and 72 at 5120), the eval
   step on its two routes at 160 decoder positions as in phase 5 (the
   `eval` line's "retro_tf"), the f32
   loss and gradients against the plain functions; one test batch of 32
   through Generator.generate at beam 20 over 160 with bf16 weights (640
   decode rows; shapes, finite non-increasing scores, 12 attention and
   24 + 18 x replays LN launches, no backward; the windows 48, 80, 160,
   each window's step one CUDA graph; the beams equal to the bit to the
   uncaptured loop's; route, steps, replays, capture ms, ms a batch, the
   encoder's and a decode step's, the card's busy ms and idle share, peak
   memory); the same batch generated in f32 with the kernels and its 640
   sequences rescored by the teacher-forced decoder with the plain
   functions, each within a stated tolerance of its beam score (the
   160-slot grouped cache, its ancestor table and bias); the host's retro
   scoring of
   5,000 x 20 beams with the trainer's workers, a gold planted at rank 3
   read back as rank 3; then scripts/torch_port/parity_run.py --recipe
   RetroSyn_tf in-process (its three searches, one epoch, validate, test
   at beam 20 over 160; launches exact, each leg timed, the trainer's
   route printed); the template phase's command line prints its trainer's
   route too;
13. the offline curation, raw rows to training: 1,000 raw condition rows
   (the schema parse_cml_reactions emits, with canonical_rxn) over 256
   reactions, skewed condition combos with empty slots and ionic reagents,
   and 1,200 corpus paragraphs, a fifth of them repeats, all from seed 0,
   through `python -m textreact_tpu_torch.preprocess.cli condition-split
   --patent_info ... --remove_threshold 10` and `dedup-corpus`, each in a
   child process in which `import pandas` fails: no canonical_rxn shared
   between train and val/test, the vocab the specials then sorted strings,
   the splits adding up to the curated rows, an id-map entry for every
   corpus row; the retrieval CLI on the curated splits (three searches, every
   nn list checked); the RCR recipe at full width (as phase 10) on the
   curated files, the curated vocab, the deduplicated corpus and those
   neighbour files: one epoch, validate, test with beam 15, the launch
   counts exact (the test pass's residual LNs from its decode steps), all
   of it through scripts/torch_port/parity_run.py in-process (it builds the
   neighbour files, three searches, then runs the recipe with
   --shuffle_smiles, which changes no launch count); then
   640 atom-mapped reactions of six families (ester, amide, SN2,
   elimination, ether, hydrogenation) with varied substituents through the
   template processor's two passes on the host, each timed: class ids 1..n,
   labels inside their tables, permutations, train coverage and the gold
   labels' decode to the reactants on the test rows at least 0.95; then
   the RetroSyn_tb recipe (as in phase 12) on the extracted labels through
   the same parity_run.py (its neighbour files built the same way);
14. the multi-device slice (textreact_tpu_torch/parallel), each leg printing
   its backend, world size and device count: the attention kernels on 6 of
   12 heads with the head offset against the full layer's keep mask and the
   plain version; leg A, this process as a world of one over NCCL
   (dp=1 x tp=1, ZeRO-1): 3 steps of the training recipe at p=0 equal to
   one device's to the bit (losses, norms, every parameter), then 3 at
   p=0.1, timed beside the train phase; leg B, dp=1 x tp=2 in two processes
   (NCCL with two cards, else both on the one card over gloo): the p=0
   loss within TP_LOSS_BOUND of leg A's, the replicated parameters equal
   to the bit on both ranks after 3 steps at p=0.1, attention at 6 heads a
   rank; leg C, FlatIndex over two corpus shards at the bench shape, equal
   to the unsharded index and the numpy oracle to the bit, timed; leg D,
   tp=2 beam-15 generation in f32 at B=32 L=512 on the uncaptured route
   (the collectives are gloo's, which no CUDA graph holds), the unsharded
   model's graphed sequences and its scores within 1e-5 + 1e-5 * |score|
   (the JAX gate's allclose), the route printed;
15. the measurement tools, through their entry points (run before phase
   14): textreact_tpu_torch.bench at its card shape (200,000 x 1024, 8192
   queries, k = 20; exact parity with the numpy oracle before any timing;
   one launch of the layout's top-k kernel per search, for each layout),
   textreact_tpu_torch.bench_train at B = 32 with the kernels (12 attention
   and 42 residual-LN launches a step, forward and backward, no top-k),
   with the plain LayerNorm (no LN launch) and with the plain MLM loss,
   then a half-minute soak with the eval and checkpoint cadences cut to 10
   and 20 s (both fire, no kernel is built, every window launches the
   kernels alike; the step-time drift is printed beside the tool's 2%
   bound, and does not fail the phase: the step is host-bound, and on the
   card's shared host the same step's host time moves by up to 1.7x
   between windows, its launching thread's CPU time with it); each tool's
   JSON line printed.

    python3 chip_smoke.py --captures

runs only the tools' long captures, each as a user runs it in a child
process: bench on the USPTO-condition-scale corpus (BENCH_N=700000) and
bench_train --soak 6 (an eval every 120 s, a checkpoint at 300 s).

Prints JSON lines of the runtime's, the pretrained start's, the template
path's, the template-free retro path's, the curation's, the tools', the parallel legs' and the eval step's numbers and of
per-kernel results, then, as the last line, {"ok": true, "device": {...}}.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import csv
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from textreact_tpu_torch import bench, bench_train
from textreact_tpu_torch.chem import canonical_smiles, parse_smiles
from textreact_tpu_torch.chem import native as native_chem
from textreact_tpu_torch.chem.smarts import find_matches, parse_smarts
from textreact_tpu_torch.cli import main as runtime_cli
from textreact_tpu_torch.config import ExperimentConfig
from textreact_tpu_torch.data import (Collator, RetrosynthesisDataset,
                                      apply_span_mlm, example_rng,
                                      read_corpus)
from textreact_tpu_torch.data.collate import _pad_2d
from textreact_tpu_torch.evaluation import (device_topk_edits,
                                            edits_from_topk, rank_edits)
from textreact_tpu_torch.evaluation.template_decode import \
    decode_template_predictions
from textreact_tpu_torch.inference import Generator, predictions_from_beams
from textreact_tpu_torch.inference.beam import _plan_windows
from textreact_tpu_torch.models import build_model
from textreact_tpu_torch.models.config import PRESETS
from textreact_tpu_torch.models.layers import (TransformerBlock, dropout,
                                               mask_to_bias)
from textreact_tpu_torch.inference.beam import ancestor_bias
from textreact_tpu_torch.ops import (_build, decode_attention, fused_attention,
                                     fused_layernorm, topk)
from textreact_tpu_torch.preprocess.condition_splits import SPECIALS
from textreact_tpu_torch.preprocess.retro_tools import canonical_rxn_smiles
from textreact_tpu_torch.retrieval import FlatIndex
from textreact_tpu_torch.retrieval import cli as retrieval_cli
from textreact_tpu_torch.templates import processor as template_processor
from textreact_tpu_torch.templates.native_extractor import demapped_canonical
from textreact_tpu_torch.tokenizers import get_tokenizers
from textreact_tpu_torch.tokenizers import native as native_tokenizer
from textreact_tpu_torch.train import (TrainState, losses,
                                       make_accum_train_step, make_eval_step,
                                       make_loss_fn, make_optimizer)
from textreact_tpu_torch.train.step import to_device
from textreact_tpu_torch.utils.table import Table, read_csv

# shapes of the two paths: B=32 requests or examples of L=512 tokens, 12
# heads of 64; LN rows are B*L in the encoder, B*beams in a decode step and
# B*DEC_LEN in the teacher-forced decoder
B, L, HEADS, HEAD_DIM, HIDDEN, BEAMS, DEC_LEN = 32, 512, 12, 64, 768, 15, 16
MICRO_BATCHES, TRAIN_STEPS, DROPOUT_P = 4, 3, 0.1
# the template-free retro recipe (scripts/torch_port/train_RetroSyn_tf.sh):
# the bert_l6 decoder over the SMILES vocabulary (591 tokens, a table of
# 600) at 160 positions, beam 20: LN rows B*160 in training, B*20 = 640 a
# decode step
RETRO_DEC_LEN, RETRO_BEAMS = 160, 20
BF16_ULP = 2.0 ** -7  # relative spacing of bf16 just above a power of two

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): the bounds
# below are the larger of bytes / memory rate and operations / peak rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}
# 32-bit integer operations outside the tensor cores: an SM has half as many
# integer lanes as f32 lanes, and an f32 FMA counts as two operations
PEAK_INT32_OPS = PEAK_FLOPS[torch.float32] / 4
# integer operations one Philox4x32-10 draw needs (csrc/philox.cuh), counted
# as the fewest the function can be done with: in each of ten rounds two
# 32 x 32 -> 64 bit products (one instruction each, taken at the full integer
# rate above: no lower rate is published for the wide form, and a bound may
# not assume one) and two three-way xors. The round keys depend on the
# call's seed alone, so their additions are made once a call, not once a
# draw, and are not counted. A draw serves four elements
PHILOX_OPS_PER_DRAW = 10 * (2 + 2)

# kernel vs plain, per dtype: (atol, rtol). f32 (the exact kernels): both
# sides compute in f32 and differ by summation order only. bf16 (the
# tensor-core kernels): products of bf16 operands summed in f32 on both
# sides, the weights rounded to bf16 before they meet v on both sides (as in
# the TPU kernel), and each side rounds its f32 result to bf16, so a result
# may land one bf16 ulp away
ATTN_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2e-2, 0.0)}
LN_TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (1.6e-2, BF16_ULP)}
# gradients, kernel vs autograd through the plain version. f32: sums of up
# to 512 (attention) or 768 (LN) terms in another order. bf16: each side
# rounds its f32 gradient to bf16, half an ulp each, and the plain attention
# rounds its weights to bf16 before they meet v. The tensor-core backward
# also rounds dS and the dropped probabilities to bf16 before their products
# (as the TPU kernel does) where autograd keeps them in f32: a relative 2^-9
# on each of up to 512 terms of mixed sign, which stays inside this bound
GRAD_TOL = {torch.float32: (2e-4, 1e-4), torch.bfloat16: (3e-2, 2.0 ** -6)}
# the bf16 tensor-core kernels against `attention_rounding_reference`, the
# plain statement of their own rounding points, (atol, rtol) for the output
# and for the gradients: the two differ by the order of the f32 sums, by the
# running maximum under which the kernel rounds a weight, and by the final
# rounding to bf16 (one ulp of the value: the relative term). That bound is
# a tenth of GRAD_TOL's, small against a typical gradient element (0.07 at
# L = 512), so a wrong scale or a misplaced fragment cannot pass. It holds
# for every element once the statement's backward reads the kernel's forward
# output, as the kernel's backward does: fed its own, delta = rowsum(dO out)
# moves where the two outputs round a value apart, a short row's dominant
# weight carries that into dS, and one dk element of 12.6 M read 4.4e-3 to
# 5.4e-3 (dk_outlier_evidence prints where it comes from)
ROUNDING_TOL, ROUNDING_GRAD_TOL = (2e-3, BF16_ULP), (4e-3, BF16_ULP)
# row statistics (attention max and normaliser, LN mean and rstd), f32 in
# every case: summation order only
STATS_TOL = (1e-4, 1e-5)
# encoder output after 12 layers, kernels vs plain functions. bf16: the two
# paths round activations to bf16 at different places and the differences
# compound through the layers (LN outputs reach |x| ~ 4-8, where one bf16
# ulp is 2^-5..2^-4). f32: summation order only
ENCODER_BOUND = {"bfloat16": 0.125, "float32": 1e-3}
# one micro-batch's f32 loss and gradients at p = 0, kernels vs plain
# functions through 12 + 6 layers: summation order only. Loss: absolute.
# Gradients: max abs difference of a tensor over its max abs value, the
# latter taken as at least TRAIN_GRAD_FLOOR of the largest gradient of all
TRAIN_LOSS_BOUND, TRAIN_GRAD_BOUND, TRAIN_GRAD_FLOOR = 1e-4, 1e-3, 1e-4
# parameters after one update at lr 1e-4, 3 real + 1 weight-0 micro-batch
# against 3 real: the same arithmetic, up to the order of torch's atomics
PAD_BOUND = 1e-6

_CSRC = "textreact_tpu_torch/csrc/"
KERNELS = {
    "fused_attention_fwd": dict(
        route="cuda", source=_CSRC + "fused_attention.cu",
        replaces="textreact_tpu/ops/fused_attention.py:60"),
    "fused_attention_bwd": dict(
        route="cuda", source=_CSRC + "fused_attention_bwd.cu",
        replaces="textreact_tpu/ops/fused_attention.py:100"),
    "fused_layernorm_fwd": dict(
        route="cuda", source=_CSRC + "fused_layernorm.cu",
        replaces="textreact_tpu/ops/fused_layernorm.py:70"),
    "fused_layernorm_bwd": dict(
        route="cuda", source=_CSRC + "fused_layernorm.cu",
        replaces="textreact_tpu/ops/fused_layernorm.py:85"),
    "causal_attention_fwd": dict(
        route="cuda", source=_CSRC + "causal_attention.cu",
        replaces="textreact_tpu/models/layers.py:94"),
    "causal_attention_bwd": dict(
        route="cuda", source=_CSRC + "causal_attention_bwd.cu",
        replaces="textreact_tpu/models/layers.py:94"),
    "exact_topk_corpus_split": dict(
        route="cuda", source=_CSRC + "exact_topk.cu",
        replaces="textreact_tpu/ops/topk.py:120"),
    "exact_topk_query_outer": dict(
        route="cuda", source=_CSRC + "exact_topk.cu",
        replaces="textreact_tpu/ops/topk.py:95"),
}
# the kernels of the recipes' shapes; the rest of KERNELS are the routes of
# the shapes past them (phase_shapes drives those)
MAIN_KERNELS = tuple(KERNELS)
KERNELS.update({
    name + suffix: KERNELS[name] for name, suffix in (
        ("fused_attention_fwd", "_padded"), ("fused_attention_bwd", "_padded"),
        ("causal_attention_fwd", "_padded"),
        ("causal_attention_bwd", "_padded"),
        ("fused_layernorm_fwd", "_wide"), ("fused_layernorm_bwd", "_wide"),
        ("exact_topk_corpus_split", "_large_k"),
        ("exact_topk_query_outer", "_large_k"))})
# the port's own kernel (a perf_opt): its launches are counted in every
# phase that decodes
KERNELS["grouped_decode_attn"] = dict(
    route="cuda", source=_CSRC + "decode_attention.cu",
    replaces="none (a perf_opt: the JAX package's decode step is XLA's)")
# the retrieval kernels by FlatIndex's corpus_resident flag
TOPK_LAYOUTS = {True: "exact_topk_corpus_split",
                False: "exact_topk_query_outer"}
# reactions of the retrieval CLI phase and of the runtime phase that trains
# on its neighbour files
RUNTIME_SIZES = {"train": 512, "val": 64, "test": 64}
CAUSAL_KERNELS = ("causal_attention_fwd", "causal_attention_bwd")
# the causal path: bert_l6's six blocks at these decoder lengths; 160
# (retro's decoder length) is not a multiple of 128 and takes the plain path
CAUSAL_LENGTHS, UNALIGNED_LENGTH = (L, 128), 160
# retrieval shapes: 8192 queries, k = 20
TOPK_M, TOPK_K = 8192, 20
# shapes past the kernels' first routes: heads of 96 run the kernels of
# width 128 at their own head dim, LayerNorm rows past 1024 take the wide
# route, k = 256 the large-k scan (items of 64 queries, runs merged into
# lists in shared memory; past 339 in device memory). phase_shapes trains
# SHAPES_BATCH examples on a model of SHAPES_HIDDEN (PAD_HEADS heads of 96:
# both routes at once) and runs causal blocks of 768 (CAUSAL_PAD_HEADS heads
# of 96);
# the kernels phase holds the routes against their plain versions at those
# heads and rows, and times the wide LN at WIDE_HIDDEN
PAD_DIM, SHAPES_HIDDEN, SHAPES_BATCH = 96, 1536, 8
PAD_HEADS, CAUSAL_PAD_HEADS = SHAPES_HIDDEN // PAD_DIM, HIDDEN // PAD_DIM
WIDE_HIDDEN, LARGE_K = 2048, 256

# the template phase: scripts/parity_run.py's RetroSyn_tb recipe
# (train_RetroSyn_tb.sh with --unattend_nonbonds, lr 2e-4, no MLM). Synthetic
# tables of 400 atom and 60 bond template classes (USPTO-50K's own are not
# bundled); bond class 1 is ester hydrolysis, the rest placeholders that
# the decode skips. Reactions of the command-line run, a split each
TEMPLATE_CLASSES = {"atom": 400, "bond": 60}
TEMPLATE_SIZES = {"train": 256, "val": 32, "test": 32}
TEMPLATE_EDITS = 500                  # reference combined_edit top 500
DECODE_K = 20                         # the retro metric's largest k
PLANT_RANK = 250                      # the gold edit's rank in the decode
ESTER_TEMPLATE = ("[C:1](=[O:2])-[O;H0;D2;+0:3]>>"
                  "[C:1](=[O:2])-[OH;D1;+0:4].[OH;D1;+0:3]")
ESTER_INFO = {"edit_site": {"B": [(1, 3)]},
              "change_H": {1: 0, 2: 0, 3: 1},
              "change_C": {1: 0, 2: 0, 3: 0},
              "change_S": {1: 0, 2: 0, 3: 0}}
# products of 21 to 50 heavy atoms: drugs, and esters with their
# hydrolysis products as the gold reactants
DRUGS = [
    "Cc1ccc(NC(=O)c2ccc(CN3CCN(C)CC3)cc2)cc1Nc1nccc(-c2cccnc2)n1",
    "CC(C)c1c(C(=O)Nc2ccccc2)c(-c2ccccc2)c(-c2ccc(F)cc2)n1CC[C@@H](O)"
    "C[C@@H](O)CC(=O)O",
    "CCCc1nn(C)c2c(=O)[nH]c(-c3cc(S(=O)(=O)N4CCN(C)CC4)ccc3OCC)nc12",
    "CCCCc1nc(Cl)c(CO)n1Cc1ccc(-c2ccccc2-c2nnn[nH]2)cc1",
    "Cc1ccc(-c2cc(C(F)(F)F)nn2-c2ccc(S(N)(=O)=O)cc2)cc1",
    "CC(C)c1nc(N(C)S(C)(=O)=O)nc(-c2ccc(F)cc2)c1/C=C/[C@@H](O)C[C@@H](O)"
    "CC(=O)O",
    "CC/C(=C(\\c1ccccc1)c1ccc(OCCN(C)C)cc1)c1ccccc1",
    "CC(C)C[C@H](NC(=O)[C@H](Cc1ccccc1)NC(=O)[C@H](CCC(=O)OC(C)(C)C)"
    "NC(=O)OCc1ccccc1)C(=O)OCc1ccccc1",
    "COc1cc2ncnc(Nc3ccc(F)c(Cl)c3)c2cc1OCCCN1CCOCC1",
    "CN(C)C(=O)Cc1c(-c2ccc(C)cc2)nc2ccc(C)cn12"]
ESTERS = {
    "CCOC(=O)c1ccc(NC(=O)c2ccc(C)cc2)cc1":
        "CCO.Cc1ccc(C(=O)Nc2ccc(C(=O)O)cc2)cc1",
    "COC(=O)c1ccc(-c2ccc(C(F)(F)F)cc2)cc1Nc1ncccn1":
        "CO.O=C(O)c1ccc(-c2ccc(C(F)(F)F)cc2)cc1Nc1ncccn1",
    "CCOC(=O)CCc1ccc(OCc2ccccc2)cc1": "CCO.O=C(O)CCc1ccc(OCc2ccccc2)cc1",
    "CC(C)OC(=O)c1cc(Cl)ccc1NS(=O)(=O)c1ccc(C)cc1":
        "CC(C)O.Cc1ccc(S(=O)(=O)Nc2ccc(Cl)cc2C(=O)O)cc1"}

WORDS = ("the mixture was stirred at room temperature for 2 h then "
         "concentrated under reduced pressure and the residue purified by "
         "column chromatography on silica gel to give the title compound as "
         "a white solid yield 85 % a solution of in dichloromethane was "
         "added dropwise to triethylamine at 0 c and heated to reflux "
         "overnight water extracted with ethyl acetate dried over sodium "
         "sulfate filtered").split()
REACTIONS = ["CC(=O)Cl.OCc1ccccc1>>CC(=O)OCc1ccccc1",
             "Brc1ccccc1.OB(O)c1ccccc1>>c1ccc(-c2ccccc2)cc1",
             "CCOC(=O)C.NCCN>>CC(=O)NCCN",
             "O=C(O)c1ccccc1.CCO>>CCOC(=O)c1ccccc1"]
# catalyst, solvent 1, solvent 2, reagent 1, reagent 2 of each reaction
# above, all in the bundled condition vocabulary
CONDITIONS = [["", "ClCCl", "", "CCN(CC)CC", ""],
              ["", "C1CCOC1", "O", "O=C([O-])[O-].[K+].[K+]", ""],
              ["", "CCO", "", "", ""],
              ["", "CCO", "", "O=S(=O)(O)O", ""]]


def log(msg: str) -> None:
    print(msg, flush=True)


_BLOCKER = None


def hold_the_card(ms: float = 60.0) -> None:
    """Queue about `ms` of large matrix products, so that the host can
    queue what follows while the card is busy and the card then runs it
    back to back: a timing after this holds device time, not the time the
    host takes to issue a launch."""
    global _BLOCKER
    if _BLOCKER is None:
        _BLOCKER = torch.zeros(8192, 8192, dtype=torch.bfloat16,
                               device="cuda")
    # 2 * 8192^3 = 1.1 TFLOP a product, some 1.5-2 ms each
    for _ in range(int(ms / 1.5)):
        torch.mm(_BLOCKER, _BLOCKER)


def time_ms(fn, reps: int = 20) -> float:
    """Median of `reps` single-call device times in ms (a pair of CUDA
    events around each call, all queued behind `hold_the_card`), after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    hold_the_card()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def wall_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of `reps` calls, each ended by a synchronize,
    after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor,
                atol: float, rtol: float) -> float:
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: the kernel's result is not finite")
    diff = (got.detach().float() - ref.detach().float()).abs()
    err = float(diff.max())
    excess = float((diff - atol - rtol * ref.detach().float().abs()).max())
    log(f"  {name}: max_abs_err {err:.3e} (tolerance atol {atol:g} + "
        f"rtol {rtol:g} * |ref|)")
    if not excess <= 0.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    """(least ms the card could take, which limit binds)."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    # the two C++ host libraries (g++) build beside the CUDA sources (nvcc)
    with ThreadPoolExecutor(max_workers=3) as pool:
        host = [pool.submit(native_tokenizer.get_lib),
                pool.submit(native_chem.get_lib)]
        _build.build_all([*fused_attention.LIBRARIES, "fused_layernorm",
                          "exact_topk", "decode_attention"])
        for future in host:
            future.result()
    fused_attention.load_kernel()
    fused_attention.load_bwd_kernel()
    fused_attention.load_causal_kernel()
    fused_attention.load_causal_bwd_kernel()
    fused_layernorm.load_kernel()
    topk.load_kernel()
    decode_attention.load_kernel()
    log(f"[build] seven libraries (nine kernels) and the two C++ host "
        f"libraries loaded in {time.perf_counter() - t0:.1f} s, built in "
        f"parallel (nvcc seconds per source: "
        f"{_build.BUILD_SECONDS or 'cached'})")
    for name, text in _build.BUILD_LOG.items():
        lines = text.splitlines()
        regs = [int(ln.split("Used ")[1].split(" registers")[0])
                for ln in lines if "Used " in ln and " registers" in ln]
        spills = {kernel: (n, spill)
                  for kernel, (n, spill) in ptxas_report(name).items()
                  if "0 bytes spill stores" not in spill}
        log(f"[build] {name}: {len(regs)} kernel variants, registers "
            f"{min(regs)}-{max(regs)}, {len(spills)} variants spill")
        for kernel, (n, spill) in sorted(spills.items()):
            log(f"[build] {name}: {kernel_name(kernel)}: {n} registers, "
                f"{spill}")


def kernel_name(mangled: str) -> str:
    """A kernel's name and the start of its template arguments, from its
    mangled name: _ZN, the anonymous namespace, then the name, each after
    its length."""
    i, parts = 3, []
    for _ in range(2):
        m = re.match(r"\d+", mangled[i:])
        if not mangled.startswith("_ZN") or m is None:
            return mangled[:60]
        i += m.end()
        parts.append(mangled[i:i + int(m.group())])
        i += int(m.group())
    return parts[1] + mangled[i:i + 16]


def reset_counts() -> None:
    fused_attention.LAUNCHES = fused_attention.BWD_LAUNCHES = 0
    fused_attention.CAUSAL_LAUNCHES = fused_attention.CAUSAL_BWD_LAUNCHES = 0
    fused_layernorm.LAUNCHES = fused_layernorm.BWD_LAUNCHES = 0
    topk.LAUNCHES.update(corpus_split=0, query_outer=0)
    fused_attention.PADDED_LAUNCHES.update(dict.fromkeys(
        fused_attention.PADDED_LAUNCHES, 0))
    fused_layernorm.WIDE_LAUNCHES = fused_layernorm.WIDE_BWD_LAUNCHES = 0
    topk.LARGE_K_LAUNCHES.update(corpus_split=0, query_outer=0)
    decode_attention.DECODE_LAUNCHES = 0


def read_counts() -> dict:
    return {"fused_attention_fwd": fused_attention.LAUNCHES,
            "fused_attention_bwd": fused_attention.BWD_LAUNCHES,
            "causal_attention_fwd": fused_attention.CAUSAL_LAUNCHES,
            "causal_attention_bwd": fused_attention.CAUSAL_BWD_LAUNCHES,
            "fused_layernorm_fwd": fused_layernorm.LAUNCHES,
            "fused_layernorm_bwd": fused_layernorm.BWD_LAUNCHES,
            "exact_topk_corpus_split": topk.LAUNCHES["corpus_split"],
            "exact_topk_query_outer": topk.LAUNCHES["query_outer"],
            "grouped_decode_attn": decode_attention.DECODE_LAUNCHES}


def read_route_counts() -> dict:
    """The launches of the routes past the recipes' shapes (read_counts
    holds the recipes' kernels)."""
    padded = fused_attention.PADDED_LAUNCHES
    return {"fused_attention_fwd_padded": padded["fwd"],
            "fused_attention_bwd_padded": padded["bwd"],
            "causal_attention_fwd_padded": padded["causal_fwd"],
            "causal_attention_bwd_padded": padded["causal_bwd"],
            "fused_layernorm_fwd_wide": fused_layernorm.WIDE_LAUNCHES,
            "fused_layernorm_bwd_wide": fused_layernorm.WIDE_BWD_LAUNCHES,
            "exact_topk_corpus_split_large_k":
                topk.LARGE_K_LAUNCHES["corpus_split"],
            "exact_topk_query_outer_large_k":
                topk.LARGE_K_LAUNCHES["query_outer"]}


def drawn_seed(gen: torch.Generator, state: torch.Tensor) -> torch.Tensor:
    """The seed a wrapper drew from `gen` when `gen` was in `state`."""
    now = gen.get_state()
    gen.set_state(state)
    seed = _build.draw_seed(gen, torch.device("cuda"))
    gen.set_state(now)
    return seed


def check_masks() -> None:
    """The dropout bits: a function of (seed, element) alone, Bernoulli
    with the right rate, different across seeds."""
    dev = torch.device("cuda")
    seed = torch.tensor([20240229], device=dev)
    a = fused_attention.keep_mask(seed, B, HEADS, L, DROPOUT_P)
    b = fused_attention.keep_mask(seed, B, HEADS, L, DROPOUT_P)
    c = fused_attention.keep_mask(seed + 1, B, HEADS, L, DROPOUT_P)
    frac = float(a.float().mean())
    log(f"[kernels] attention keep mask ({B}, {HEADS}, {L}, {L}) at p="
        f"{DROPOUT_P}: keep fraction {frac:.5f} (1 - p +- 0.005); same seed "
        f"same bits: {torch.equal(a, b)}; next seed agrees on "
        f"{float((a == c).float().mean()):.4f} of elements")
    if not (abs(frac - (1 - DROPOUT_P)) < 0.005 and torch.equal(a, b)
            and not torch.equal(a, c)):
        raise AssertionError("attention keep mask")
    per_head = a.float().mean(dim=(2, 3))
    if not float((per_head - (1 - DROPOUT_P)).abs().max()) < 0.005:
        raise AssertionError("attention keep mask is uneven across heads")
    a = fused_layernorm.keep_mask(seed, B * L, HIDDEN, DROPOUT_P)
    b = fused_layernorm.keep_mask(seed, B * L, HIDDEN, DROPOUT_P)
    c = fused_layernorm.keep_mask(seed + 1, B * L, HIDDEN, DROPOUT_P)
    frac = float(a.float().mean())
    log(f"[kernels] layernorm keep mask ({B * L}, {HIDDEN}): keep fraction "
        f"{frac:.5f}; same seed same bits: {torch.equal(a, b)}")
    if not (abs(frac - (1 - DROPOUT_P)) < 0.005 and torch.equal(a, b)
            and not torch.equal(a, c)):
        raise AssertionError("layernorm keep mask")


def sdpa(q, k, v, key_mask, p):
    """The one PyTorch call that computes the attention kernel's function
    (timed as a yardstick, used nowhere in the port)."""
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=key_mask, dropout_p=p).transpose(1, 2)


def dk_outlier_evidence(tag, q, k, v, do, mask, scale, keep, p, stats, out,
                        own_out, got_dk, want_dk) -> None:
    """Where the dk element of the kernel furthest beyond the tight bound of
    the rounding statement comes from: its coordinates, and the dS terms of
    its column that round differently, each before and after rounding in the
    kernel's order (the forward's saved row max and normaliser, exp(s scale
    + bias - m) * (1 / l), delta from the kernel's forward output `out`, the
    dK/dV pass's arithmetic) and in the statement's (exp over the row
    divided by its sum, delta from the statement's own output `own_out`),
    with their deltas and what each moves dk by."""
    diff = (got_dk.float() - want_dk.float()).abs()
    atol, rtol = ROUNDING_GRAD_TOL
    excess = diff - atol - rtol * want_dk.float().abs()
    b, key, h, col = np.unravel_index(int(excess.argmax()), diff.shape)
    n = q.shape[1]
    qf, kf, vf, gf = (t[b, :, h].float() for t in (q, k, v, do))
    bias = (torch.where(mask[b] > 0, 0.0, -1e9).float()
            if mask is not None else torch.zeros(n, device=q.device))
    s_row = qf @ kf.T * scale + bias[None, :]             # (queries, keys)
    delta_k = (gf * out[b, :, h].float()).sum(-1)
    delta_s = (gf * own_out[b, :, h].float()).sum(-1)
    dprob = gf @ vf[key]
    kept = torch.ones_like(dprob, dtype=torch.bool)
    inv = 1.0
    if keep is not None:
        kept, inv = keep[b, h, :, key], 1.0 / (1.0 - p)
    g = torch.where(kept, dprob * inv, 0.0)
    m, l = stats[b, h, :, 0], stats[b, h, :, 1]
    p_kernel = torch.exp((qf @ kf[key]) * scale + bias[key] - m) * (1.0 / l)
    e = torch.exp(s_row - s_row.amax(-1, keepdim=True))
    p_statement = e[:, key] / e.sum(-1)
    ds_k = p_kernel * (g - delta_k) * scale
    ds_s = p_statement * (g - delta_s) * scale
    r_k, r_s = ds_k.bfloat16().float(), ds_s.bfloat16().float()
    moves = (r_k - r_s) * qf[:, col]
    flipped = torch.nonzero(r_k != r_s).flatten()
    # the statement's dS with the kernel's delta: what the two outputs move
    by_delta = ((p_statement * (g - delta_k) * scale).bfloat16().float()
                - r_s) * qf[:, col]
    log(f"  {tag} dk element furthest beyond the tight bound of the statement "
        f"fed its own output (batch {b}, "
        f"key {key}, head {h}, dim {col}): kernel "
        f"{float(got_dk[b, key, h, col]):.6e}, statement "
        f"{float(want_dk[b, key, h, col]):.6e}, |diff| "
        f"{float(diff[b, key, h, col]):.3e} (bound {atol:g} + {rtol:g} * "
        f"|statement|, excess {float(excess[b, key, h, col]):.3e}); "
        f"{len(flipped)} of {n} rounded dS terms differ, moving dk by "
        f"{float(moves.sum()):.3e} together; of that, the deltas of the two "
        f"outputs alone {float(by_delta.sum()):.3e}")
    for i in flipped[torch.argsort(-moves[flipped].abs())][:3].tolist():
        log(f"    query {i}: dS kernel order {float(ds_k[i]):.9e} -> "
            f"{float(r_k[i]):.9e}, statement order {float(ds_s[i]):.9e} -> "
            f"{float(r_s[i]):.9e}; weight {float(p_statement[i]):.4f}, delta "
            f"{float(delta_k[i]):.6f} (kernel's out) / {float(delta_s[i]):.6f}"
            f" (statement's); q {float(qf[i, col]):.4f}; moves dk by "
            f"{float(moves[i]):.3e}")


def check_rounding(tag, q, k, v, do, mask, scale, keep, p, causal, out,
                   leaves, stats=None) -> None:
    """The bf16 tensor-core kernels' out against the plain statement of
    their own rounding points, and dq, dk, dv against the statement's
    backward reading the kernel's forward output (the kernels' backward
    reads the forward's): every element within the tight bound. With the
    forward's `stats`, the dk element furthest from the statement that reads
    its own output is taken apart."""
    want = fused_attention.attention_rounding_reference(
        q, k, v, do, mask, scale, keep, p, causal=causal, out=out.detach())
    got = (out, *(leaf.grad for leaf in leaves))
    if stats is not None:
        own = fused_attention.attention_rounding_reference(
            q, k, v, do, mask, scale, keep, p, causal=causal)
        dk_outlier_evidence(tag, q, k, v, do, mask, scale, keep, p, stats,
                            out.detach(), own[0], got[2], own[2])
        del own
    tols = (ROUNDING_TOL, *[ROUNDING_GRAD_TOL] * 3)
    for name, a, ref, (atol, rtol) in zip(("out", "dq", "dk", "dv"), got,
                                          want, tols):
        ref = ref.float()
        diff = (a.detach().float() - ref).abs()
        outliers = int((diff - rtol * ref.abs() > atol).sum())
        log(f"  {tag} {name} against the rounding statement: max_abs_err "
            f"{float(diff.max()):.3e}; {outliers} of {diff.numel()} "
            f"elements beyond atol {atol:g} + rtol {rtol:g} * |ref|")
        if not (torch.isfinite(a).all() and outliers == 0):
            raise AssertionError(f"{tag} {name}: kernel disagrees with the "
                                 f"statement of its rounding points")


def kernels_attention(results: dict, heads: int = HEADS,
                      dim: int = HEAD_DIM, suffix: str = "") -> None:
    """The attention kernels at B=32 L=512 and `heads` heads of `dim`
    against the plain version (f32, bf16; p = 0 and 0.1 with the kernel's
    own keep mask), their rounding points and statistics, then timed;
    results under fused_attention_{fwd,bwd} + `suffix`."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    lengths = rng.integers(64, L + 1, B)
    lengths[0] = L
    lengths[-1] = 0  # a collator dummy row: every key masked
    mask = torch.as_tensor(np.arange(L)[None, :] < lengths[:, None],
                           dtype=torch.int32, device=dev)
    scale = dim ** -0.5
    log(f"[kernels] attention B={B} L={L} H={heads} D={dim}, ragged "
        f"mask, row {B - 1} fully masked")
    errs = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(B, L, heads, dim, generator=gen,
                                   device=dev).to(dtype) for _ in range(4))
        for p in (0.0, DROPOUT_P):
            tag = f"attention D={dim} {str(dtype)[6:]} p={p}"
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            state = gen.get_state()
            out = fused_attention.fused_dropout_attention(*leaves, mask, p,
                                                          gen, scale)
            stats = out.grad_fn.saved_tensors[4]
            out.backward(do)
            keep = None
            if p > 0.0:
                seed = drawn_seed(gen, state)
                keep = fused_attention.keep_mask(seed, B, heads, L, p)
                again = [t.clone().requires_grad_() for t in (q, k, v)]
                gen.set_state(state)
                out2 = fused_attention.fused_dropout_attention(
                    *again, mask, p, gen, scale)
                out2.backward(do)
                same = torch.equal(out, out2) and all(
                    torch.equal(a.grad, b.grad)
                    for a, b in zip(leaves, again))
                log(f"  {tag}: two calls with one seed give the same bits: "
                    f"{same}")
                if not same:
                    raise AssertionError("attention is not reproducible")
            ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            ref = fused_attention.attention_reference(*ref_leaves, mask,
                                                      scale, keep, p)
            ref.backward(do)
            torch.cuda.synchronize()
            e = check_close(f"{tag} out", out, ref, *ATTN_TOL[dtype])
            if dtype == torch.bfloat16:
                errs["fwd"] = max(errs["fwd"], e)
            for name, a, b in zip("qkv", leaves, ref_leaves):
                e = check_close(f"{tag} d{name}", a.grad, b.grad,
                                *GRAD_TOL[dtype])
                if dtype == torch.bfloat16:
                    errs["bwd"] = max(errs["bwd"], e)
            del ref, ref_leaves
            if dtype == torch.bfloat16:
                check_rounding(tag, q, k, v, do, mask, scale, keep, p, False,
                               out, leaves, stats)
            if dtype == torch.float32 and p == 0.0:
                # row log-sum-exp from the saved (max, normaliser), valid
                # rows only: in the all-masked row m is -1e9, where m + log l
                # is not representable (why the pair is saved, not the sum)
                s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
                s = s + torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
                lse = stats[..., 0] + torch.log(stats[..., 1])
                check_close("attention f32 lse (rows 0..B-2)", lse[:-1],
                            torch.logsumexp(s, -1)[:-1], *STATS_TOL)
        if dtype == torch.bfloat16:
            time_attention(results, q, k, v, do, mask, gen, scale, lengths,
                           errs, suffix)


def ragged_holes_mask(batch: int, n: int, rng) -> np.ndarray:
    """A key mask that is no prefix: holes anywhere, the first key tile
    (64) masked whole, a middle tile masked whole in row 0 where there is
    one, row 1 fully valid, the last row with no valid key."""
    mask = rng.random((batch, n)) < 0.6
    mask[:, :64] = False
    if n >= 256:
        mask[0, 128:192] = False
    mask[1] = True
    mask[-1] = False
    return mask


def kernels_attention_shapes() -> None:
    """The bf16 tensor-core kernels at every instantiated head dim and two
    below the next width (96, 48), two lengths, under a mask that is no
    prefix, non-causal (p = 0 and 0.1) and causal, against the plain
    version with the kernel's own keep mask."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(3)
    batch, dtype = 4, torch.bfloat16
    for dim in (*fused_attention.SUPPORTED_HEAD_DIM, PAD_DIM, 48):
        for n in (128, L):
            mask = torch.as_tensor(ragged_holes_mask(batch, n, rng),
                                   dtype=torch.int32, device=dev)
            q, k, v, do = (torch.randn(batch, n, HEADS, dim, generator=gen,
                                       device=dev).to(dtype)
                           for _ in range(4))
            scale = dim ** -0.5
            log(f"[kernels] attention bf16 B={batch} L={n} H={HEADS} "
                f"D={dim}, mask with holes and whole tiles masked")
            for causal, p in ((False, 0.0), (False, DROPOUT_P), (True, 0.0)):
                tag = (f"{'causal ' if causal else ''}attention D={dim} "
                       f"L={n} holes p={p}")
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                state = gen.get_state()
                if causal:
                    out = fused_attention.causal_attention(*leaves, mask,
                                                           scale)
                else:
                    out = fused_attention.fused_dropout_attention(
                        *leaves, mask, p, gen, scale)
                out.backward(do)
                keep = None
                if p > 0.0:
                    keep = fused_attention.keep_mask(drawn_seed(gen, state),
                                                     batch, HEADS, n, p)
                ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                ref = fused_attention.attention_reference(
                    *ref_leaves, mask, scale, keep, p, causal=causal)
                ref.backward(do)
                torch.cuda.synchronize()
                check_close(f"{tag} out", out, ref, *ATTN_TOL[dtype])
                for name, a, b in zip("qkv", leaves, ref_leaves):
                    check_close(f"{tag} d{name}", a.grad, b.grad,
                                *GRAD_TOL[dtype])
                check_rounding(tag, q, k, v, do, mask, scale, keep, p, causal,
                               out, leaves)


def attention_probe_inputs(dev, batch: int, heads: int, n: int, dim: int):
    """(q, k, v) in bf16 that give the dropout bits away: q = 0 makes every
    weight 1 / n, and k and v hold w(i) and 64 w(i) at column i % dim of
    row i and 0 elsewhere, w = 1 below row dim and 2 from there. With v as
    v (the forward), v as dO (dV) or dO of ones (dQ, through k), an output
    element at n = 2 dim is a sum over two mask bits with weights 1 and 2."""
    rows = torch.arange(n, device=dev)
    probe = torch.zeros(n, dim, device=dev)
    probe[rows, rows % dim] = torch.where(rows < dim, 1.0, 2.0)
    probe = probe[None, :, None, :].expand(batch, n, heads, dim)
    q = torch.zeros(batch, n, heads, dim, dtype=torch.bfloat16, device=dev)
    return (q, probe.to(torch.bfloat16).contiguous(),
            (64 * probe).to(torch.bfloat16).contiguous())


def check_dropout_bits() -> None:
    """The forward, the dQ pass and the dK/dV pass (which reads the bits
    the dQ pass drew) work with the bits that `keep_mask` exports, shown on
    `attention_probe_inputs` at L = 128 and p = 0.5: out and dv then hold
    small integers and equal the plain statement of the kernels' arithmetic
    to the bit; dq (dO of ones) is held to one bf16 ulp. One flipped bit in
    the exported mask must break each of the three."""
    dev = torch.device("cuda")
    batch, heads, n, dim, p = 2, 2, 128, 64, 0.5
    q, k, v = attention_probe_inputs(dev, batch, heads, n, dim)
    gen = torch.Generator(device=dev).manual_seed(11)
    results = {}
    for name, do in (("dv", v), ("dq", torch.ones_like(v))):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        state = gen.get_state()
        out = fused_attention.fused_dropout_attention(*leaves, None, p, gen,
                                                      1.0)
        out.backward(do)
        keep = fused_attention.keep_mask(drawn_seed(gen, state), batch,
                                         heads, n, p)
        flipped = keep.clone()
        flipped[1, 1, 70, 5] = ~flipped[1, 1, 70, 5]
        want = fused_attention.attention_rounding_reference(
            q, k, v, do, None, 1.0, keep, p)
        wrong = fused_attention.attention_rounding_reference(
            q, k, v, do, None, 1.0, flipped, p)
        got = dict(out=out, dq=leaves[0].grad, dv=leaves[2].grad)
        torch.cuda.synchronize()
        for key, i in (("out", 0), (name, 1 if name == "dq" else 3)):
            if key == "dq":
                def same(ref):
                    diff = (got["dq"].float() - ref.float()).abs()
                    return bool((diff <= 1e-3 + BF16_ULP
                                 * ref.float().abs()).all())
            else:
                def same(ref, key=key):
                    return torch.equal(got[key], ref)
            results[key] = (same(want[i]), same(wrong[i]))
    log(f"[kernels] attention dropout bits at L={n} p={p}, (agrees with the "
        f"exported mask, agrees with one bit flipped): {results}")
    if any(r != (True, False) for r in results.values()):
        raise AssertionError("a kernel works with other bits than "
                             "keep_mask exports")


def time_attention(results, q, k, v, do, mask, gen, scale, lengths, errs,
                   suffix=""):
    """bf16 times at the training shape (p = 0.1) and the serving shape
    (p = 0, no statistics written), with bounds from this run's mask and
    q's own head dim (a padded call's bound is the unpadded work's)."""
    p = DROPOUT_P
    dtype = q.dtype
    heads, dim = q.shape[2:]
    elems = q.numel()
    # keys a row's data needs: its valid ones (all L in the all-masked row,
    # whose softmax is uniform)
    keys = float(np.where(lengths == 0, L, lengths).sum())
    fwd_flops = 4.0 * heads * dim * L * keys
    bwd_flops = 10.0 * heads * dim * L * keys
    stats_bytes = B * heads * L * 8
    fwd_bytes = 4 * elems * q.element_size() + mask.numel() * 4
    bwd_bytes = (8 * elems * q.element_size() + mask.numel() * 4
                 + stats_bytes)
    key_mask = (mask > 0)[:, None, None, :]

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with torch.no_grad():
        ms_p0 = time_ms(lambda: fused_attention.fused_dropout_attention(
            q, k, v, mask, 0.0, None, scale))
        plain_p0 = time_ms(lambda: fused_attention.attention_reference(
            q, k, v, mask, scale))
        lib_p0 = time_ms(lambda: sdpa(q, k, v, key_mask, 0.0))
    fwd_ms = time_ms(lambda: fused_attention.fused_dropout_attention(
        *leaves, mask, p, gen, scale))
    out = fused_attention.fused_dropout_attention(*leaves, mask, p, gen,
                                                  scale)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                 retain_graph=True))
    keep = fused_attention.keep_mask(
        torch.tensor([1], device=q.device), B, heads, L, p)
    plain_fwd = time_ms(lambda: fused_attention.attention_reference(
        *leaves, mask, scale, keep, p))
    ref = fused_attention.attention_reference(*leaves, mask, scale, keep, p)
    plain_bwd = time_ms(lambda: torch.autograd.grad(ref, leaves, do,
                                                    retain_graph=True))
    del ref, keep
    lib_fwd = time_ms(lambda: sdpa(*leaves, key_mask, p))
    lib_out = sdpa(*leaves, key_mask, p)
    lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, leaves, do,
                                                  retain_graph=True))
    # with dropout, one draw per four elements over the valid keys, once in
    # the forward and once in the backward (its dQ pass draws, its dK/dV
    # pass reads those bits)
    draw_ops = PHILOX_OPS_PER_DRAW * heads * L * keys / 4
    draw_ms = draw_ops / PEAK_INT32_OPS * 1e3
    fb0, fby0 = bound(fwd_bytes, fwd_flops, dtype)
    fb, fby = bound(fwd_bytes + stats_bytes, fwd_flops, dtype)
    bb, bby = bound(bwd_bytes, bwd_flops, dtype)
    if draw_ms > fb:
        fb, fby = draw_ms, "operations"
    if draw_ms > bb:
        bb, bby = draw_ms, "operations"
    log(f"  attention D={dim} bf16 forward p={p} (writes row statistics): "
        f"kernel "
        f"{fwd_ms:.4f} ms, plain {plain_fwd:.4f} ms, SDPA {lib_fwd:.4f} ms, "
        f"bound {fb:.4f} ms ({fby}: {fwd_flops / 1e9:.2f} GFLOP over valid "
        f"keys, {(fwd_bytes + stats_bytes) / 1e6:.1f} MB, "
        f"{draw_ops / 1e9:.2f} G integer operations of the generator = "
        f"{draw_ms:.4f} ms)")
    log(f"  attention D={dim} bf16 forward p=0 (serving): kernel "
        f"{ms_p0:.4f} ms, "
        f"plain {plain_p0:.4f} ms, SDPA {lib_p0:.4f} ms, bound {fb0:.4f} ms "
        f"({fby0})")
    passes = device_ms_by_kernel(
        lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
        {"dq": ("attention_bwd_dq", 1), "dkv": ("attention_bwd_dkv", 1)})
    log(f"  attention D={dim} bf16 backward p={p}: kernel {bwd_ms:.4f} ms "
        f"(profiler: "
        f"dQ pass {fmt_ms(passes['dq'], 4)}, dK/dV pass "
        f"{fmt_ms(passes['dkv'], 4)}), plain "
        f"autograd backward {plain_bwd:.4f} ms (forward + backward "
        f"{plain_fwd + plain_bwd:.4f} ms), SDPA backward {lib_bwd:.4f} ms, "
        f"bound {bb:.4f} ms ({bby}: {bwd_flops / 1e9:.2f} GFLOP, "
        f"{bwd_bytes / 1e6:.1f} MB, the generator once = "
        f"{draw_ms:.4f} ms)")
    padded = {}
    if fused_attention.kernel_head_dim(dim) != dim:
        padded = true_dim_against_padded(
            f"attention D={dim} bf16 p={p}", q, k, v, do, mask, scale, p,
            False, dict(fwd=fwd_ms, bwd=bwd_ms, lib_fwd=lib_fwd,
                        lib_bwd=lib_bwd))
    results["fused_attention_fwd" + suffix] = dict(
        max_abs_err=errs["fwd"], ms=fwd_ms, plain_ms=plain_fwd, bound_ms=fb,
        bound_by=fby, library_ms=lib_fwd, ms_p0=ms_p0, plain_ms_p0=plain_p0,
        library_ms_p0=lib_p0, bound_ms_p0=fb0, bound_by_p0=fby0,
        **({"ms_on_padded_inputs": padded["fwd"]} if padded else {}))
    results["fused_attention_bwd" + suffix] = dict(
        max_abs_err=errs["bwd"], ms=bwd_ms, plain_ms=plain_bwd, bound_ms=bb,
        bound_by=bby, library_ms=lib_bwd,
        plain_fwd_bwd_ms=plain_fwd + plain_bwd,
        **({"ms_on_padded_inputs": padded["bwd"]} if padded else {}),
        **{f"{label}_pass_ms": ms for label, ms in passes.items()
           if ms is not None})


def true_dim_against_padded(tag, q, k, v, do, mask, scale, p, causal,
                            times) -> dict:
    """A head dim below the kernels' width W: the call at the true head
    dim (no copies) against the same kernels on q, k, v, dO zero-padded to
    W beforehand, with the same scale and seed. Output and gradients must
    be equal to the bit; the padded call's forward and backward are timed
    and printed beside `times` (the true-D call's and SDPA's, ms)."""
    dim = q.shape[-1]
    width = fused_attention.kernel_head_dim(dim)

    def forward(leaves, gen):
        if causal:
            return fused_attention.causal_attention(*leaves, mask, scale)
        return fused_attention.fused_dropout_attention(*leaves, mask, p, gen,
                                                       scale)

    narrow = [t.clone().requires_grad_() for t in (q, k, v)]
    wide = [F.pad(t, (0, width - dim)).requires_grad_() for t in (q, k, v)]
    wide_do = F.pad(do, (0, width - dim))
    gens = [torch.Generator(device=q.device).manual_seed(7) for _ in "ab"]
    out = forward(narrow, gens[0])
    out.backward(do, retain_graph=True)
    wide_out = forward(wide, gens[1])
    wide_out.backward(wide_do, retain_graph=True)
    torch.cuda.synchronize()
    bits = torch.int16 if q.dtype == torch.bfloat16 else torch.int32
    for name, a, b in zip(("out", "dq", "dk", "dv"),
                          [out] + [t.grad for t in narrow],
                          [wide_out] + [t.grad for t in wide]):
        if not torch.equal(a.view(bits), b[..., :dim].contiguous().view(bits)):
            raise AssertionError(f"{tag}: {name} at head dim {dim} differs "
                                 f"from the call padded to {width}")
    fwd = time_ms(lambda: forward(wide, gens[1]))
    bwd = time_ms(lambda: torch.autograd.grad(wide_out, wide, wide_do,
                                              retain_graph=True))
    log(f"  {tag}: output and gradients equal to the bit to the {width}-wide "
        f"kernels on inputs zero-padded beforehand; forward {times['fwd']:.4f}"
        f" ms at D={dim}, {fwd:.4f} ms padded beforehand, SDPA "
        f"{times['lib_fwd']:.4f} ms; backward {times['bwd']:.4f} ms, "
        f"{bwd:.4f} ms padded, SDPA {times['lib_bwd']:.4f} ms")
    return {"fwd": fwd, "bwd": bwd}


def causal_allowed(mask: torch.Tensor) -> torch.Tensor:
    """(B, 1, L, L) bool: key j is valid and not above query i."""
    n = mask.shape[1]
    below = torch.ones(n, n, dtype=torch.bool, device=mask.device).tril()
    return (mask > 0)[:, None, None, :] & below


def causal_keys(lengths: np.ndarray, n: int) -> float:
    """Keys the rows of this run's data need: row i of an example with
    `length` valid keys sees min(i + 1, length) of them (all i + 1 in an
    all-masked example, whose rows are uniform over what they see)."""
    rows = np.arange(1, n + 1)[None, :]
    seen = np.minimum(rows, np.where(lengths == 0, n, lengths)[:, None])
    return float(seen.sum())


def kernels_causal_attention(results: dict, heads: int = HEADS,
                             dim: int = HEAD_DIM, lengths_run=CAUSAL_LENGTHS,
                             suffix: str = "") -> None:
    """The causal kernels at B=32, `heads` heads of `dim`, each length of
    `lengths_run`, against the plain version, then timed; results under
    causal_attention_{fwd,bwd} + `suffix`."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(2)
    scale = dim ** -0.5
    names = [name + suffix for name in CAUSAL_KERNELS]
    for name in names:
        results[name] = dict(max_abs_err=0.0)
    for n in lengths_run:
        lengths = rng.integers(n // 8, n + 1, B)
        lengths[0] = n
        lengths[-1] = 0  # a collator dummy row: every key masked
        mask = torch.as_tensor(np.arange(n)[None, :] < lengths[:, None],
                               dtype=torch.int32, device=dev)
        log(f"[kernels] causal attention B={B} L={n} H={heads} D={dim}, "
            f"ragged mask, row {B - 1} fully masked, no dropout")
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(B, n, heads, dim, generator=gen,
                                       device=dev).to(dtype)
                           for _ in range(4))
            tag = f"causal attention D={dim} L={n} {str(dtype)[6:]}"
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = fused_attention.causal_attention(*leaves, mask, scale)
            stats = out.grad_fn.saved_tensors[4]
            out.backward(do)
            ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            ref = fused_attention.attention_reference(
                *ref_leaves, mask, scale, causal=True)
            ref.backward(do)
            torch.cuda.synchronize()
            e = check_close(f"{tag} out", out, ref, *ATTN_TOL[dtype])
            if dtype == torch.bfloat16:
                results[names[0]]["max_abs_err"] = max(
                    results[names[0]]["max_abs_err"], e)
            for name, a, b in zip("qkv", leaves, ref_leaves):
                e = check_close(f"{tag} d{name}", a.grad, b.grad,
                                *GRAD_TOL[dtype])
                if dtype == torch.bfloat16:
                    results[names[1]]["max_abs_err"] = max(
                        results[names[1]]["max_abs_err"], e)
            del ref, ref_leaves
            if dtype == torch.bfloat16:
                check_rounding(tag, q, k, v, do, mask, scale, None, 0.0, True,
                               out, leaves)
            if dtype == torch.float32:
                s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
                s = s + torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
                s = s.masked_fill(~causal_allowed(torch.ones_like(mask)),
                                  float("-inf"))
                lse = stats[..., 0] + torch.log(stats[..., 1])
                check_close(f"{tag} lse (rows 0..B-2)", lse[:-1],
                            torch.logsumexp(s, -1)[:-1], *STATS_TOL)
        time_causal_attention(results, n, q, k, v, do, mask, scale, lengths,
                              names)


def time_causal_attention(results, n, q, k, v, do, mask, scale, lengths,
                          names=CAUSAL_KERNELS):
    """bf16 times of the causal kernels beside the plain version, SDPA under
    the joined boolean mask (timed only; its all-masked rows are NaN) and the
    bound from this run's mask. L=512 is the kernels' line; L=128 rides
    along under its own keys."""
    dtype = q.dtype
    elems = q.numel()
    heads, dim = q.shape[2:]
    keys = causal_keys(lengths, n)
    fwd_flops = 4.0 * heads * dim * keys
    bwd_flops = 10.0 * heads * dim * keys
    stats_bytes = B * heads * n * 8
    fwd_bytes = 4 * elems * q.element_size() + mask.numel() * 4 + stats_bytes
    bwd_bytes = (8 * elems * q.element_size() + mask.numel() * 4
                 + stats_bytes)
    allowed = causal_allowed(mask)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd_ms = time_ms(lambda: fused_attention.causal_attention(
        *leaves, mask, scale))
    out = fused_attention.causal_attention(*leaves, mask, scale)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                 retain_graph=True))
    plain_fwd = time_ms(lambda: fused_attention.attention_reference(
        *leaves, mask, scale, causal=True))
    ref = fused_attention.attention_reference(*leaves, mask, scale,
                                              causal=True)
    plain_bwd = time_ms(lambda: torch.autograd.grad(ref, leaves, do,
                                                    retain_graph=True))
    del ref
    lib_fwd = time_ms(lambda: sdpa(*leaves, allowed, 0.0))
    lib_out = sdpa(*leaves, allowed, 0.0)
    lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, leaves, do,
                                                  retain_graph=True))
    fb, fby = bound(fwd_bytes, fwd_flops, dtype)
    bb, bby = bound(bwd_bytes, bwd_flops, dtype)
    padded = {}
    if fused_attention.kernel_head_dim(dim) != dim:
        padded = true_dim_against_padded(
            f"causal attention D={dim} bf16 L={n}", q, k, v, do, mask, scale,
            0.0, True, dict(fwd=fwd_ms, bwd=bwd_ms, lib_fwd=lib_fwd,
                            lib_bwd=lib_bwd))
    log(f"  causal attention D={dim} bf16 L={n} forward (writes row "
        f"statistics): "
        f"kernel {fwd_ms:.4f} ms, plain {plain_fwd:.4f} ms, SDPA "
        f"{lib_fwd:.4f} ms, bound {fb:.4f} ms ({fby}: "
        f"{fwd_flops / 1e9:.2f} GFLOP over the keys each row sees, "
        f"{fwd_bytes / 1e6:.1f} MB)")
    log(f"  causal attention D={dim} bf16 L={n} backward: kernel "
        f"{bwd_ms:.4f} ms, "
        f"plain autograd backward {plain_bwd:.4f} ms, SDPA backward "
        f"{lib_bwd:.4f} ms, bound {bb:.4f} ms ({bby}: "
        f"{bwd_flops / 1e9:.2f} GFLOP, {bwd_bytes / 1e6:.1f} MB)")
    fwd = dict(ms=fwd_ms, plain_ms=plain_fwd, bound_ms=fb, bound_by=fby,
               library_ms=lib_fwd,
               **({"ms_on_padded_inputs": padded["fwd"]} if padded else {}))
    bwd = dict(ms=bwd_ms, plain_ms=plain_bwd, bound_ms=bb, bound_by=bby,
               library_ms=lib_bwd,
               **({"ms_on_padded_inputs": padded["bwd"]} if padded else {}))
    if n != L:
        fwd = {f"{key}_L{n}": val for key, val in fwd.items()}
        bwd = {f"{key}_L{n}": val for key, val in bwd.items()}
    results[names[0]].update(fwd)
    results[names[1]].update(bwd)


def check_layernorm(tag, x, y, g, w, b, gen, eps, p):
    """One forward and backward of the residual-LN kernels against the
    plain version (with the kernel's own keep mask at p > 0), mean and rstd
    against their definition; returns the max abs errors of out and of dx,
    dy."""
    rows, hidden = x.shape
    leaves = [t.clone().requires_grad_() for t in (x, y, w, b)]
    state = gen.get_state()
    out = fused_layernorm.fused_residual_layernorm(*leaves, eps, p, gen)
    mean, rstd = out.grad_fn.saved_tensors[3:5]
    out.backward(g)
    keep = None
    if p > 0.0:
        keep = fused_layernorm.keep_mask(drawn_seed(gen, state), rows,
                                         hidden, p)
    ref_leaves = [t.clone().requires_grad_() for t in (x, y, w, b)]
    ref = fused_layernorm.residual_layernorm_reference(*ref_leaves, eps,
                                                       keep, p)
    ref.backward(g)
    torch.cuda.synchronize()
    dtype = x.dtype
    e_out = check_close(f"{tag} out", out, ref, *LN_TOL[dtype])
    z = x.float() + y.float() * (
        1.0 if keep is None else keep.float() / (1.0 - p))
    var = (z * z).mean(-1) - z.mean(-1) ** 2
    check_close(f"{tag} mean", mean, z.mean(-1), *STATS_TOL)
    check_close(f"{tag} rstd", rstd, torch.rsqrt(var.clamp(min=0) + eps),
                *STATS_TOL)
    e_grad = 0.0
    for name, a, c in zip(("dx", "dy"), leaves, ref_leaves):
        e_grad = max(e_grad, check_close(f"{tag} {name}", a.grad, c.grad,
                                         *GRAD_TOL[dtype]))
    # dscale, dbias: f32 sums over R rows of terms of size ~1
    for name, a, c in zip(("dscale", "dbias"), leaves[2:], ref_leaves[2:]):
        check_close(f"{tag} {name}", a.grad, c.grad, 1e-5 * rows + 1e-4,
                    1e-4)
    return e_out, e_grad


def layernorm_inputs(gen, rows: int, hidden: int, dtype):
    """x, y, g of (rows, hidden) in dtype; scale and bias in f32."""
    x, y, g = (torch.randn(rows, hidden, generator=gen,
                           device="cuda").to(dtype) for _ in range(3))
    w = 1.0 + 0.1 * torch.randn(hidden, generator=gen, device="cuda")
    b = 0.1 * torch.randn(hidden, generator=gen, device="cuda")
    return x, y, g, w, b


def kernels_layernorm(results: dict, hidden: int = HIDDEN,
                      row_counts=(B * L, B * DEC_LEN, B * BEAMS,
                                  B * RETRO_DEC_LEN, B * RETRO_BEAMS),
                      suffix: str = "") -> None:
    """The residual-LN kernels at `hidden` and each row count, f32 and
    bf16, p = 0 and 0.1, then timed in bf16; results under
    fused_layernorm_{fwd,bwd} + `suffix`, the first row count the line's."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    eps = 1e-5
    errs = {"fwd": 0.0, "bwd": 0.0}
    for rows in row_counts:
        log(f"[kernels] residual LayerNorm R={rows} H={hidden}")
        for dtype in (torch.float32, torch.bfloat16):
            x, y, g, w, b = layernorm_inputs(gen, rows, hidden, dtype)
            for p in (0.0, DROPOUT_P):
                e_out, e_grad = check_layernorm(
                    f"layernorm R={rows} H={hidden} {str(dtype)[6:]} p={p}",
                    x, y, g, w, b, gen, eps, p)
                if dtype == torch.bfloat16 and rows == row_counts[0]:
                    errs["fwd"] = max(errs["fwd"], e_out)
                    errs["bwd"] = max(errs["bwd"], e_grad)
            if dtype == torch.bfloat16:
                time_layernorm(results, rows, x, y, g, w, b, gen, eps, errs,
                               rows == row_counts[0], suffix)


def library_layernorm_backward(x, y, g, w, b, eps):
    """Yardstick, timed only and used nowhere in the port: the one PyTorch
    call that computes the LN kernels' backward at p = 0 (dx, dscale,
    dbias; dres = dx), on the forward's own mean and rstd."""
    z = x + y
    wd, bd = w.to(x.dtype), b.to(x.dtype)
    _, mean, rstd = torch.ops.aten.native_layer_norm(z, (x.shape[1],), wd,
                                                     bd, eps)
    return lambda: torch.ops.aten.native_layer_norm_backward(
        g, z, (x.shape[1],), mean, rstd, wd, bd, [True, True, True])


def time_layernorm(results, rows, x, y, g, w, b, gen, eps, errs, line,
                   suffix=""):
    """The LN kernels at one row count, bf16: the forward at p = 0 without
    statistics (serving's call), the forward at p = 0.1 writing mean and
    rstd as the call (it draws its seed: one more small kernel) and as the
    kernel alone on a seed drawn beforehand, the backward (its seed is the
    forward's: the kernel alone), each beside its byte bound and the share
    of the bound reached."""
    p = DROPOUT_P
    hidden = x.shape[1]
    leaves = [t.clone().requires_grad_() for t in (x, y, w, b)]
    with torch.no_grad():
        ms_p0 = time_ms(lambda: fused_layernorm.fused_residual_layernorm(
            x, y, w, b, eps))
        plain_p0 = time_ms(
            lambda: fused_layernorm.residual_layernorm_reference(
                x, y, w, b, eps))
        two_calls = time_ms(lambda: F.layer_norm(x + y, (hidden,),
                                                 w.to(x.dtype),
                                                 b.to(x.dtype), eps))
        lib_bwd = time_ms(library_layernorm_backward(x, y, g, w, b, eps))
        # PyTorch's streaming rate over the kernels' bytes: torch.add reads
        # two rows and writes one (the forward's), torch.mul then reads and
        # writes one more (the backward's five)
        o1, o2 = torch.empty_like(x), torch.empty_like(x)
        add_ms = time_ms(lambda: torch.add(x, y, out=o1))
        add_mul_ms = time_ms(lambda: (torch.add(x, y, out=o1),
                                      torch.mul(g, 2.0, out=o2)))
        seed = _build.draw_seed(gen, x.device)
        kernel_ms = time_ms(
            lambda: fused_layernorm._FusedResidualLayerNorm.apply(
                x, y, w, b, seed, eps, p, True))
    fwd_ms = time_ms(lambda: fused_layernorm.fused_residual_layernorm(
        *leaves, eps, p, gen))
    out = fused_layernorm.fused_residual_layernorm(*leaves, eps, p, gen)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, g,
                                                 retain_graph=True))
    keep = fused_layernorm.keep_mask(torch.tensor([1], device=x.device),
                                     rows, hidden, p)
    plain_fwd = time_ms(lambda: fused_layernorm.residual_layernorm_reference(
        *leaves, eps, keep, p))
    ref = fused_layernorm.residual_layernorm_reference(*leaves, eps, keep, p)
    plain_bwd = time_ms(lambda: torch.autograd.grad(ref, leaves, g,
                                                    retain_graph=True))
    size = x.numel() * x.element_size()
    p0_bytes = 3 * size + 2 * hidden * 4
    fwd_bytes = p0_bytes + 2 * rows * 4
    bwd_bytes = 5 * size + 3 * hidden * 4 + 2 * rows * 4
    p0b, _ = bound(p0_bytes, 10.0 * x.numel(), torch.float32)
    fb, fby = bound(fwd_bytes, 10.0 * x.numel(), torch.float32)
    bb, bby = bound(bwd_bytes, 20.0 * x.numel(), torch.float32)
    log(f"  layernorm R={rows} H={hidden} bf16 forward p={p} (writes mean, "
        f"rstd): call {fwd_ms:.4f} ms (draws its seed), kernel alone "
        f"{kernel_ms:.4f} ms ({fb / kernel_ms:.1%} of the bound), plain "
        f"{plain_fwd:.4f} ms, bound {fb:.4f} ms ({fby}: "
        f"{fwd_bytes / 1e6:.2f} MB); p=0 without statistics: kernel "
        f"{ms_p0:.4f} ms ({p0b / ms_p0:.1%} of its bound {p0b:.4f} ms), "
        f"plain {plain_p0:.4f} ms; for information, F.layer_norm(x + y), "
        f"two calls with a two-pass variance: {two_calls:.4f} ms, and "
        f"torch.add over the forward's bytes {add_ms:.4f} ms")
    log(f"  layernorm R={rows} H={hidden} bf16 backward p={p}: kernel "
        f"{bwd_ms:.4f} ms ({bb / bwd_ms:.1%} of the bound), plain autograd "
        f"backward {plain_bwd:.4f} ms (forward + backward "
        f"{plain_fwd + plain_bwd:.4f} ms), aten.native_layer_norm_backward "
        f"at p=0 {lib_bwd:.4f} ms, torch.add + torch.mul over its bytes "
        f"{add_mul_ms:.4f} ms, bound {bb:.4f} ms ({bby}: "
        f"{bwd_bytes / 1e6:.2f} MB)")
    fwd_name, bwd_name = ("fused_layernorm_fwd" + suffix,
                          "fused_layernorm_bwd" + suffix)
    if line:
        results[fwd_name] = dict(
            max_abs_err=errs["fwd"], ms=fwd_ms, plain_ms=plain_fwd,
            bound_ms=fb, bound_by=fby, library_ms=None, kernel_ms=kernel_ms,
            share_of_bound=fb / kernel_ms, ms_p0=ms_p0, plain_ms_p0=plain_p0,
            bound_ms_p0=p0b, add_ms=add_ms)
        results[bwd_name] = dict(
            max_abs_err=errs["bwd"], ms=bwd_ms, plain_ms=plain_bwd,
            bound_ms=bb, bound_by=bby, library_ms=lib_bwd,
            share_of_bound=bb / bwd_ms,
            plain_fwd_bwd_ms=plain_fwd + plain_bwd, add_mul_ms=add_mul_ms)
    else:
        results[fwd_name].update({
            f"ms_rows_{rows}": fwd_ms, f"kernel_ms_rows_{rows}": kernel_ms,
            f"bound_ms_rows_{rows}": fb, f"ms_p0_rows_{rows}": ms_p0,
            f"bound_ms_p0_rows_{rows}": p0b, f"add_ms_rows_{rows}": add_ms})
        results[bwd_name].update({
            f"ms_rows_{rows}": bwd_ms, f"bound_ms_rows_{rows}": bb,
            f"library_ms_rows_{rows}": lib_bwd,
            f"add_mul_ms_rows_{rows}": add_mul_ms})


def kernels_layernorm_wide(results: dict) -> None:
    """The wide route (hidden > 1024): the line's shape, the rows that
    phase_shapes gives it (its encoder's and its decoder's at
    SHAPES_HIDDEN), then the route's ragged ends (1152: a thread's second
    group of four columns only partly used; 8192: eight full groups) at a
    few rows, f32 and bf16, p = 0 and 0.1."""
    kernels_layernorm(results, WIDE_HIDDEN, (B * L, 7), "_wide")
    gen = torch.Generator(device="cuda").manual_seed(4)
    for rows, hidden in ((SHAPES_BATCH * L, SHAPES_HIDDEN),
                         (SHAPES_BATCH * DEC_LEN, SHAPES_HIDDEN),
                         (5, 1152), (5, fused_layernorm.MAX_HIDDEN)):
        for dtype in (torch.float32, torch.bfloat16):
            x, y, g, w, b = layernorm_inputs(gen, rows, hidden, dtype)
            for p in (0.0, DROPOUT_P):
                check_layernorm(f"layernorm R={rows} H={hidden} "
                                f"{str(dtype)[6:]} p={p}", x, y, g, w, b,
                                gen, 1e-5, p)


def phase_kernels(results: dict) -> None:
    check_masks()
    check_dropout_bits()
    kernels_attention(results)
    kernels_attention(results, PAD_HEADS, PAD_DIM, "_padded")
    kernels_attention_shapes()
    kernels_causal_attention(results)
    kernels_causal_attention(results, CAUSAL_PAD_HEADS, PAD_DIM, (L,),
                             "_padded")
    kernels_layernorm(results)
    kernels_layernorm_wide(results)
    kernels_topk_small()
    torch.cuda.empty_cache()


# the grouped decode self-attention's shapes: (examples, heads, beams, head
# dim, decoder positions, window) of retro serving's three windows and RCR
# serving's one; a window's steps run from the length past the previous
# window up to the window
DECODE_SHAPES = {"retro48": (B, HEADS, RETRO_BEAMS, HEAD_DIM, RETRO_DEC_LEN, 48),
                 "retro80": (B, HEADS, RETRO_BEAMS, HEAD_DIM, RETRO_DEC_LEN, 80),
                 "retro160": (B, HEADS, RETRO_BEAMS, HEAD_DIM, RETRO_DEC_LEN,
                              160),
                 "rcr16": (B, HEADS, BEAMS, HEAD_DIM, DEC_LEN, DEC_LEN)}
DECODE_FIRST_LENGTH = {"retro48": 1, "retro80": 49, "retro160": 81,
                       "rcr16": 1}


def decode_attention_inputs(shape, cur_len: int, dtype, seed: int):
    """(q, cache_k, cache_v, ancestry bias at cur_len) on the card."""
    Bex, H, G, D, T, W = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(Bex * H, G, D, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(Bex, H, D, T * G, generator=g,
                        device="cuda").to(dtype) for _ in range(2))
    src = torch.randint(0, G, (Bex, G, W), generator=g, device="cuda")
    return q, k, v, ancestor_bias(src, cur_len, Bex, G, W)


def phase_decode_attention(results: dict) -> dict:
    """The grouped decode self-attention kernel at the serving cells'
    shapes, bf16, both score dtypes: against the plain version (a bf16 ulp
    of the context) and float64 (no further than 1.25 times the plain
    version), then timed at three lengths of each window (the masked tiles
    past the length are not read) beside its bound at the full window (K
    and V bytes), the plain version and SDPA over transposed copies with
    the bias as its mask (timed only); the float32 route checked and timed
    at retro's last window. The launches here are no part of the main
    path's count: the counter is set back as it was."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {}
    counted = decode_attention.DECODE_LAUNCHES
    for tag, shape in DECODE_SHAPES.items():
        Bex, H, G, D, T, W = shape
        scale = 1.0 / math.sqrt(D)
        first = DECODE_FIRST_LENGTH[tag]
        row = {"kernel_ms": {}}
        for cur_len in sorted({first, (first + W) // 2, W}):
            q, k, v, bias = decode_attention_inputs(shape, cur_len,
                                                    torch.bfloat16, cur_len)
            for round_scores in (True, False):
                got = decode_attention.grouped_decode_attention(
                    q, k, v, bias, scale, round_scores)
                torch.cuda.synchronize()
                plain = decode_attention.grouped_decode_attention_reference(
                    q, k, v, bias, scale, round_scores)
                check_close(f"decode attention {tag} len {cur_len} "
                            f"round {round_scores}", got, plain, 2e-2, 0.0)
                kk = k[..., :W * G].double().reshape(Bex * H, D, W * G)
                vv = v[..., :W * G].double().reshape(Bex * H, D, W * G)
                p = torch.softmax(
                    (torch.bmm(q.double(), kk).view(Bex, H, G, W * G) * scale
                     + bias.double()[:, None]), -1).view(Bex * H, G, W * G)
                exact = torch.bmm(p, vv.transpose(1, 2))
                err = float((got.double() - exact).abs().max())
                plain_err = float((plain.double() - exact).abs().max())
                log(f"  against float64: kernel {err:.3e}, plain "
                    f"{plain_err:.3e}")
                if not err <= 1.25 * plain_err:
                    raise AssertionError(f"decode attention {tag}: {err} "
                                         f"against float64, plain "
                                         f"{plain_err}")
            row["kernel_ms"][cur_len] = time_ms(
                lambda: decode_attention.grouped_decode_attention(
                    q, k, v, bias, scale, True))
        # at the full window: the bound, the plain version, SDPA
        nbytes = 2 * Bex * H * D * W * G * 2
        flops = 4 * Bex * H * G * W * G * D
        row["bound_ms"], row["binds"] = bound(nbytes, flops, torch.bfloat16)
        row["plain_ms"] = time_ms(
            lambda: decode_attention.grouped_decode_attention_reference(
                q, k, v, bias, scale, True))
        q4 = q.view(Bex, H, G, D)
        kt = k[..., :W * G].transpose(2, 3).contiguous()
        vt = v[..., :W * G].transpose(2, 3).contiguous()
        mask = bias[:, None].to(torch.bfloat16)
        row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, scale=scale))
        del kt, vt, mask
        log(f"[decode attention] {tag}: kernel ms by length "
            f"{row['kernel_ms']}, bound {row['bound_ms']:.4f} "
            f"({row['binds']}), plain {row['plain_ms']:.4f}, SDPA "
            f"{row['library_ms']:.4f}")
        out[tag] = row
    shape = DECODE_SHAPES["retro160"]
    q, k, v, bias = decode_attention_inputs(shape, 120, torch.float32, 7)
    got = decode_attention.grouped_decode_attention(q, k, v, bias, 0.125,
                                                    True)
    check_close("decode attention f32 retro160", got,
                decode_attention.grouped_decode_attention_reference(
                    q, k, v, bias, 0.125, True), 2e-5, 0.0)
    out["float32_retro160_ms"] = time_ms(
        lambda: decode_attention.grouped_decode_attention(
            q, k, v, bias, 0.125, True))
    log(f"[decode attention] float32 at retro160, length 120: "
        f"{out['float32_retro160_ms']:.4f} ms")
    decode_attention.DECODE_LAUNCHES = counted
    results["grouped_decode_attn"] = {}
    torch.cuda.empty_cache()
    return out


def write_text_vocab(path: Path) -> None:
    """A WordPiece vocab (SciBERT's is not bundled): specials, the words
    above, and every printable character alone and as a continuation, so
    SMILES split into characters rather than [UNK]."""
    chars = [chr(c) for c in range(33, 127) if not chr(c).isupper()]
    tokens = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
              + sorted(set(WORDS)) + chars + ["##" + c for c in chars])
    path.write_text("\n".join(dict.fromkeys(tokens)) + "\n")


def encode_request(enc_tok, rng, i: int, length: int) -> dict:
    """Request i (reaction SMILES + retrieved neighbour paragraphs),
    tokenized and cut to `length`; every fourth one short."""
    n_nb, n_words = (1, 20) if i % 4 == 3 else (3, 200)
    texts = [" ".join(rng.choice(WORDS, n_words)) for _ in range(n_nb)]
    enc = enc_tok(REACTIONS[i % len(REACTIONS)], text_pair=texts)
    return {k: v[:length] for k, v in enc.items()}


def make_requests(enc_tok, n: int, length: int, seed: int = 0) -> dict:
    """n tokenized requests padded to `length` with numpy."""
    rng = np.random.default_rng(seed)
    ids = np.full((n, length), enc_tok.pad_token_id, np.int32)
    mask = np.zeros((n, length), np.int32)
    for i in range(n):
        row = encode_request(enc_tok, rng, i, length)["input_ids"]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return {"input_ids": ids, "attention_mask": mask,
            "indices": np.arange(n, dtype=np.int32),
            "example_mask": np.ones(n, np.int32)}


def make_train_batch(cfg, enc_tok, dec_tok, n: int, seed: int = 0):
    """n training examples as the dataset builds them (tokenized request,
    span MLM with masked-first reordering, the reaction's conditions as
    decoder tokens), collated at the encoder length cfg.max_length."""
    import random
    rng = np.random.default_rng(seed)
    py_rng = random.Random(seed)
    examples = []
    for i in range(n):
        ex = encode_request(enc_tok, rng, i, cfg.max_length)
        ids, position_ids, mlm_labels = apply_span_mlm(
            ex["input_ids"], enc_tok.mask_token_id, cfg.mlm_ratio, rng=py_rng)
        dec = dec_tok(CONDITIONS[i % len(CONDITIONS)])
        examples.append({
            "id": str(i), "index": i, "input_ids": ids,
            "attention_mask": ex["attention_mask"],
            "position_ids": position_ids, "mlm_labels": mlm_labels,
            "decoder_input_ids": dec["input_ids"][:cfg.max_dec_length],
            "decoder_attention_mask":
                dec["attention_mask"][:cfg.max_dec_length]})
    collate = Collator(cfg, enc_tok.pad_token_id, dec_tok.pad_token_id)
    return collate(examples, fixed_enc_len=cfg.max_length)


def set_kernels(module: torch.nn.Module, on: bool) -> None:
    """Route every layer through the kernels or through the plain
    functions (the JAX package's attention_impl / layernorm_impl flags)."""
    for m in module.modules():
        if hasattr(m, "config"):
            m.config = m.config.replace(
                attention_impl="flash" if on else "xla",
                layernorm_impl="fused" if on else "xla")


def set_dropout(module: torch.nn.Module, p: float) -> None:
    for m in module.modules():
        if hasattr(m, "config"):
            m.config = m.config.replace(hidden_dropout_prob=p,
                                        attention_probs_dropout_prob=p)


def base_config(vocab: Path, **kw) -> ExperimentConfig:
    return ExperimentConfig(
        task="condition", encoder="scibert_base", decoder="bert_l6",
        max_length=L, max_dec_length=DEC_LEN, num_beams=BEAMS,
        test_batch_size=B, compute_dtype="bfloat16",
        attention_impl="flash", layernorm_impl="fused",
        text_vocab_file=str(vocab), **kw)


def describe(module, enc_cfg, dec_cfg) -> str:
    return (f"encoder {enc_cfg.num_hidden_layers}x{enc_cfg.hidden_size} "
            f"vocab {enc_cfg.vocab_size}, decoder "
            f"{dec_cfg.num_hidden_layers}x{dec_cfg.hidden_size} vocab "
            f"{dec_cfg.vocab_size}, "
            f"{sum(p.numel() for p in module.parameters()) / 1e6:.1f} M "
            f"params stored as "
            f"{module.encoder.layers[0].ffn.output.weight.dtype}")


def idle_share(busy_ms: Optional[float], span_ms: float) -> str:
    """The share of a call's host-clock span in which the card ran
    nothing, or "not measured"."""
    if busy_ms is None:
        return "not measured"
    return f"{1.0 - busy_ms / span_ms:.1%}"


def decode_graphs_report(gen: Generator) -> dict:
    """The graphs a Generator's first batch of a key captured, printed:
    route, steps, replays, capture ms."""
    out = dict(route=gen.route, steps=gen.last_steps,
               replays=gen.last_replays, capture_ms=gen.last_capture_ms)
    if gen.route == "cuda_graphs" and not gen.last_capture_ms > 0:
        raise AssertionError(f"the first batch captured no graph: {out}")
    log(f"  decode: route {gen.route}, {gen.last_steps} steps, "
        f"{gen.last_replays} replays, capture {gen.last_capture_ms:.1f} ms")
    return out


def check_against_uncaptured(what: str, gen: Generator, batch: dict,
                             got: tuple) -> None:
    """The batch again through the uncaptured device-state loop on the same
    weights (`route = "uncaptured"`): beams, scores and steps equal to the
    bit. The launch counters are left as they were."""
    ref = Generator(gen.module, num_beams=gen.num_beams,
                    max_length=gen.max_length, attn_windows=gen.attn_windows)
    ref.route = "uncaptured"
    before = read_counts()
    seqs, scores = ref.generate(batch)
    torch.cuda.synchronize()
    fused_attention.LAUNCHES = before["fused_attention_fwd"]
    fused_layernorm.LAUNCHES = before["fused_layernorm_fwd"]
    decode_attention.DECODE_LAUNCHES = before["grouped_decode_attn"]
    same = (np.array_equal(got[0], seqs) and got[1].dtype == scores.dtype
            and np.array_equal(got[1].view(np.uint32),
                               scores.view(np.uint32)))
    log(f"  {what}: graphed beams against the uncaptured loop's on the same "
        f"batch: {'equal to the bit' if same else 'DIFFERENT'} (steps "
        f"{gen.last_steps} and {ref.last_steps})")
    if not same or ref.last_steps != gen.last_steps:
        rows = np.nonzero((got[0] != seqs).any((1, 2))
                          | (got[1] != scores).any(1))[0]
        raise AssertionError(f"{what}: the graphed decode departs from the "
                             f"uncaptured loop in requests {rows}")


def phase_serving(card: str, vocab: Path, results: dict) -> None:
    # serving holds its weights pre-cast to the compute dtype
    cfg = base_config(vocab, param_dtype="bfloat16")
    enc_tok, dec_tok = get_tokenizers(cfg)
    t0 = time.perf_counter()
    module, enc_cfg, dec_cfg = build_model(cfg, enc_tok, dec_tok,
                                           torch.Generator().manual_seed(0))
    log(f"[serve] model built on {next(module.parameters()).device} in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{describe(module, enc_cfg, dec_cfg)}")
    batch = make_requests(enc_tok, B, L)
    lens = batch["attention_mask"].sum(1)
    log(f"[serve] {B} requests, tokens per request min {lens.min()} max "
        f"{lens.max()}")
    gen = Generator(module, num_beams=BEAMS, max_length=DEC_LEN)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    seqs, scores = gen.generate(batch)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps, replays = gen.last_steps, gen.last_replays
    log(f"[serve] launches: {counts} over {steps} decode steps, {replays} "
        f"replays ({gen.route})")
    enc_layers, dec_layers = (enc_cfg.num_hidden_layers,
                              dec_cfg.num_hidden_layers)
    if counts["grouped_decode_attn"] != dec_layers * replays:
        raise AssertionError(f"decode attention launches {counts}, "
                             f"{replays} replays")
    results["grouped_decode_attn"]["launches"] = counts["grouped_decode_attn"]
    if counts["fused_attention_fwd"] != enc_layers:
        raise AssertionError(f"attention launches {counts}")
    if steps < 1 or counts["fused_layernorm_fwd"] != (
            2 * enc_layers + 3 * dec_layers * replays):
        raise AssertionError(f"layernorm launches {counts}, {replays} "
                             f"replays")
    if counts["fused_attention_bwd"] or counts["fused_layernorm_bwd"]:
        raise AssertionError(f"serving launched a backward kernel: {counts}")
    for name in ("fused_attention_fwd", "fused_layernorm_fwd"):
        results[name]["launches_serving"] = counts[name]
    capture = decode_graphs_report(gen)
    check_against_uncaptured("serving", gen, batch, (seqs, scores))

    preds = predictions_from_beams(seqs, scores, batch["indices"],
                                   batch["example_mask"], dec_tok)
    if seqs.shape != (B, BEAMS, DEC_LEN) or scores.shape != (B, BEAMS):
        raise AssertionError(f"shapes {seqs.shape} {scores.shape}")
    if not np.isfinite(scores).all():
        raise AssertionError("non-finite beam scores")
    if not (np.diff(scores, axis=1) <= 0).all():
        raise AssertionError("beam scores increase across beams")
    if len(preds) != B or any(len(p["prediction"]) != BEAMS
                              for p in preds.values()):
        raise AssertionError("predictions_from_beams lost requests")
    log(f"[serve] request 0 best beam {preds[0]['prediction'][0]} score "
        f"{preds[0]['score'][0]:.3f}")

    ids = torch.as_tensor(batch["input_ids"], dtype=torch.long,
                          device="cuda")
    mask = torch.as_tensor(batch["attention_mask"], device="cuda")
    batch_ms = wall_ms(lambda: gen.generate(batch))
    with torch.inference_mode():
        enc_ms = wall_ms(lambda: module.encode(ids, mask))
    busy_ms, _ = device_busy_ms(
        lambda: gen.generate(batch),
        {"residual_layernorm_fwd": counts["fused_layernorm_fwd"]})
    log(f"[serve] {batch_ms:.1f} ms/batch (host clock, median of 5) for "
        f"B={B} L={L} beam {BEAMS} dec {DEC_LEN}, windows "
        f"{_plan_windows(DEC_LEN, gen.attn_windows)}, {steps} decode "
        f"steps in {replays} replays ({replays - steps} past the stop) of "
        f"the {gen.route} route, on {card}; the encoder alone (uncaptured) "
        f"{enc_ms:.1f} ms, cache set-up and beam search the other "
        f"{batch_ms - enc_ms:.1f} ms, {(batch_ms - enc_ms) / steps:.2f} ms a "
        f"decode step; the card busy {fmt_ms(busy_ms, 1)} of the batch "
        f"(torch.profiler), idle {idle_share(busy_ms, batch_ms)}; capture "
        f"{capture['capture_ms']:.1f} ms in the first batch; peak device "
        f"memory {peak_gb:.2f} GB. Random "
        f"weights rarely emit EOS, so this is the worst case with no early "
        f"stop.")

    # the batch's encoder states through the kernels and through the plain
    # functions: the bf16 serving model, and the same seed built in f32
    f32, _, _ = build_model(
        dataclasses.replace(cfg, compute_dtype="float32",
                            param_dtype="float32"),
        enc_tok, dec_tok, torch.Generator().manual_seed(0))
    for name, m in (("bfloat16", module), ("float32", f32)):
        with torch.inference_mode():
            with_kernels = m.encode(ids, mask)
            set_kernels(m, False)
            before = read_counts()
            plain = m.encode(ids, mask)
            set_kernels(m, True)
        torch.cuda.synchronize()
        if read_counts() != before:
            raise AssertionError("the plain encoder pass launched a kernel")
        diff = float((with_kernels.float() - plain.float()).abs().max())
        log(f"[serve] encoder states, kernels vs plain functions, {name}: "
            f"max abs diff {diff:.3e} (bound {ENCODER_BOUND[name]:g})")
        if not diff <= ENCODER_BOUND[name]:
            raise AssertionError(f"{name} encoder with kernels departs from "
                                 f"the plain path")


def train_config(vocab: Path, **kw) -> ExperimentConfig:
    """scripts/train_RCR.sh: MLM auxiliary head, clip 5, AdamW lr 1e-4 wd
    0.01, cosine schedule with warmup 0.02, global batch 128."""
    kw.setdefault("compute_dtype", "bfloat16")
    cfg = base_config(vocab, mlm=True, mlm_layer="mlp", mlm_lambda=0.1,
                      mlm_ratio=0.15, batch_size=B * MICRO_BATCHES, lr=1e-4,
                      weight_decay=0.01, max_grad_norm=5.0,
                      scheduler="cosine", warmup_ratio=0.02,
                      param_dtype="float32")
    return dataclasses.replace(cfg, **kw)


def as_microbatches(batch, n: int) -> dict:
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
            for k, v in batch.arrays.items()}


HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def host_launch_calls(fn) -> int:
    """The kernel launches, graph launches and copies the host issued in
    one call of `fn`, from torch.profiler's runtime events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.name in HOST_LAUNCH_CALLS for ev in prof.events()
               if ev.device_type != torch.autograd.DeviceType.CUDA)


def train_snapshot(module, optimizer) -> dict:
    """Copies of every parameter and both moments of every parameter."""
    return {"params": [p.detach().clone() for p in module.parameters()],
            "exp_avg": [t.clone() for t in optimizer.exp_avg],
            "exp_avg_sq": [t.clone() for t in optimizer.exp_avg_sq]}


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (warn_only, as the parallel phase
    takes them), new tensors left unfilled. Without them torch's embedding
    backward sums the rows of a table that many tokens look up by atomics,
    in an order that varies from run to run: on an H100 with torch 2.11,
    twenty backward passes of the token-type table at 32 x 512 tokens
    differ by up to 2.4e-4 and of the position table by up to 9.5e-7, and
    two uncaptured runs of one train step differ in those tables' last
    bits. Under them the two runs are equal to the bit."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def differing(a: dict, b: dict, names: list) -> dict:
    """{tensor: max |a - b| / max |b|} of the tensors of two
    train_snapshot()s that are not equal to the bit."""
    return {f"{part} {names[i]}": float(
                (x - y).abs().max() / y.abs().max().clamp(min=1e-30))
            for part in a for i, (x, y) in enumerate(zip(a[part], b[part]))
            if not torch.equal(x, y)}


def run_route(route: str, module, cfg, optimizer, pad_id: int, micro,
              state: TrainState) -> dict:
    """TRAIN_STEPS steps of the accumulated train step on `route`, from the
    weights and moments the module and optimizer hold: the metrics and host
    ms of each step (synchronized before and after), the launches of all
    of them (counters set to 0 just before, read just after), peak
    memory, and the end state."""
    step = make_accum_train_step(module, cfg, optimizer, pad_id)
    if step.route != "cuda_graphs":
        raise AssertionError(f"the train step's route on one card is "
                             f"{step.route}")
    step.route = route
    weights = np.ones(MICRO_BATCHES, np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    history, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, micro, weights, cfg.seed)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append(metrics)
        log(f"[train] {route} step {state.step}: "
            f"{ {k: float(v) for k, v in metrics.items()} } lr "
            f"{optimizer.schedule(state.step - 1):.3g} {step_ms[-1]:.1f} ms")
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    return dict(step=step, state=state, history=history, step_ms=step_ms,
                counts=counts, peak_gb=peak_gb,
                end=train_snapshot(module, optimizer))


def capture_by_key(graphs) -> dict:
    """ms each capture of a train step's graphs took: the update part's and
    each key's micro-batch part's, labelled by the key's input shapes."""
    out = {"update": round(graphs.update.capture_ms, 1)}
    for key, part in graphs.keys.items():
        shapes = {name: shape for name, shape, _ in key}
        label = "micro " + "x".join(map(str, shapes.get("input_ids", ())))
        if "decoder_input_ids" in shapes:
            label += " dec " + "x".join(map(str, shapes["decoder_input_ids"]))
        out[label] = round(part.micro.capture_ms, 1)
    return out


def uncaptured_peak_gb(module, cfg, optimizer, pad_id: int, micro,
                       step_count: int) -> float:
    """Peak device memory of one accumulated train step of `micro` on the
    uncaptured route, from the weights and moments that the module and the
    optimizer hold, put back after it (their copies wait on the host), the
    launch counters left as they were: the uncaptured route's figure beside
    a phase's graphed steps."""
    params = [p.detach().cpu() for p in module.parameters()]
    saved = optimizer.state_dict()
    saved["moments"] = {n: {k: v.cpu() for k, v in m.items()}
                        for n, m in saved["moments"].items()}
    counters = (fused_attention.LAUNCHES, fused_attention.BWD_LAUNCHES,
                fused_layernorm.LAUNCHES, fused_layernorm.BWD_LAUNCHES)
    step = make_accum_train_step(module, cfg, optimizer, pad_id)
    step.route = "uncaptured"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(TrainState(module, optimizer, step_count), micro,
         np.ones(MICRO_BATCHES, np.float32), cfg.seed)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        for p, p0 in zip(module.parameters(), params):
            p.copy_(p0)
    optimizer.load_state_dict(saved)
    (fused_attention.LAUNCHES, fused_attention.BWD_LAUNCHES,
     fused_layernorm.LAUNCHES, fused_layernorm.BWD_LAUNCHES) = counters
    return peak_gb


def route_timing(card: str, run: dict, micro, cfg, per_mb: dict) -> dict:
    """A route's host ms (median of steps 2-3), the card's span of a step
    (CUDA events), its busy ms and idle share (torch.profiler), the host's
    launch calls a step, capture ms per key and peak memory, printed."""
    step, state = run["step"], run["state"]
    weights = np.ones(MICRO_BATCHES, np.float32)
    box = {"state": state}

    def one_step():
        box["state"], _ = step(box["state"], micro, weights, cfg.seed)

    host_ms = statistics.median(run["step_ms"][1:])
    span_ms = device_span_ms(one_step)
    expect = {"residual_layernorm_fwd": per_mb["fused_layernorm_fwd"]
              * MICRO_BATCHES,
              "residual_layernorm_bwd": per_mb["fused_layernorm_bwd"]
              * MICRO_BATCHES,
              "attention_fwd": per_mb["fused_attention_fwd"] * MICRO_BATCHES}
    busy_ms, kernels = device_busy_ms(one_step, expect)
    calls = host_launch_calls(one_step)
    capture = {} if step.graphs is None else capture_by_key(step.graphs)
    out = dict(route=step.route, host_ms=host_ms, device_span_ms=span_ms,
               busy_ms=busy_ms, idle=idle_share(busy_ms, host_ms),
               device_kernels=kernels, host_launch_calls=calls,
               capture_ms=capture, peak_gb=run["peak_gb"])
    log(f"[train] route {step.route}: {host_ms:.1f} ms a step (host clock, "
        f"median of steps 2-{TRAIN_STEPS}; step 1 {run['step_ms'][0]:.1f} "
        f"ms), the card's span {span_ms:.1f} ms (CUDA events, median of 2), "
        f"busy {fmt_ms(busy_ms, 1)} ({kernels} kernels and copies), idle "
        f"{out['idle']} of the host's step; the host issued {calls} kernel "
        f"launches, graph launches and copies a step; capture ms by key "
        f"{capture}; peak device memory {run['peak_gb']:.1f} GB; on {card}")
    return out


EVAL_ROUTES = ("cuda_graphs", "uncaptured")


def eval_labels(step) -> dict:
    """ms each key's capture of an eval step's forward took, labelled by
    the key's input shapes."""
    out = {}
    for key, part in ({} if step.graphs is None else step.graphs.keys).items():
        shapes = {name: shape for name, shape, _ in key}
        label = "x".join(map(str, shapes["input_ids"]))
        for name in ("decoder_input_ids", "atom_indices", "bond_pairs"):
            if name in shapes:
                label += f" {name.split('_')[0]} " + "x".join(
                    map(str, shapes[name][1:]))
        out[label] = round(part.forward.capture_ms, 1)
    return out


def eval_routes(card: str, tag: str, module, cfg, pad_id: int, batches: list,
                per_batch: dict, results: dict, edit_topk: int = 1):
    """The eval step on its two routes over `batches` of one key (the first
    captures, the others replay), each route from fresh counters: every
    output of every batch equal to the bit once all calls are made (so a
    later call left each result as it was), the launches exact on both
    (`per_batch`: read_counts' name -> launches a batch); then each
    route's host ms a batch (median of 5, synchronized), the card's span
    (CUDA events) and busy ms and idle share (profiler), the host's launch
    calls a batch, keys and capture ms, and the peak device memory of the
    calls (the capture included), printed. Returns (the graphed step, the
    numbers by route); `results[tag]` takes the graphed launches."""
    steps, outs, peak = {}, {}, {}
    for route in EVAL_ROUTES:
        step = make_eval_step(module, cfg, pad_id, edit_topk=edit_topk)
        if step.route != "cuda_graphs":
            raise AssertionError(f"[{tag}] the eval step's route on one card "
                                 f"is {step.route}")
        step.route = route
        steps[route] = step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        outs[route] = [step(batch) for batch in batches]
        torch.cuda.synchronize()
        counts = read_counts()
        peak[route] = torch.cuda.max_memory_allocated() / 1e9
        want = dict.fromkeys(counts, 0)
        want.update({k: v * len(batches) for k, v in per_batch.items()})
        if counts != want:
            raise AssertionError(f"[{tag}] eval step, {route}: launches "
                                 f"{counts}, expected {want}")
    for name, n in per_batch.items():
        results[name][f"launches_eval_{tag}"] = n * len(batches)
    unequal = [f"batch {i} {k}"
               for i, (a, b) in enumerate(zip(*outs.values()))
               for k in sorted(set(a) | set(b))
               if k not in a or k not in b or a[k].dtype != b[k].dtype
               or not torch.equal(a[k], b[k])]
    log(f"[{tag}] eval step on {len(batches)} batches of one key "
        f"(top {edit_topk}): graphed route against the uncaptured route: "
        + ("every output equal to the bit" if not unequal else
           f"DIFFERENT: {unequal[:10]}"))
    if unequal:
        raise AssertionError(f"[{tag}] the graphed eval step departs from "
                             f"the uncaptured one: {unequal[:10]}")
    graphed = steps["cuda_graphs"]
    if len(graphed.graphs.keys) != 1 or next(iter(
            graphed.graphs.keys.values())).forward.replays != len(batches) - 1:
        raise AssertionError(f"[{tag}] eval graphs: {eval_labels(graphed)}")
    expect = {"attention_fwd": per_batch.get("fused_attention_fwd", 0),
              "residual_layernorm_fwd": per_batch["fused_layernorm_fwd"]}
    batch = batches[-1]
    out = {"card": card}
    for route, step in steps.items():
        call = lambda: step(batch)   # noqa: E731
        host_ms = wall_ms(call)
        span_ms = device_span_ms(call)
        busy_ms, kernels = device_busy_ms(call, expect)
        calls = host_launch_calls(call)
        out[route] = dict(host_ms=host_ms, device_span_ms=span_ms,
                          busy_ms=busy_ms, idle=idle_share(busy_ms, host_ms),
                          device_kernels=kernels, host_launch_calls=calls,
                          keys=len(eval_labels(step)),
                          capture_ms=eval_labels(step), peak_gb=peak[route])
        log(f"[{tag}] eval route {route}: {host_ms:.2f} ms a batch (host "
            f"clock, median of 5), the card's span {span_ms:.2f} ms (CUDA "
            f"events), busy {fmt_ms(busy_ms, 2)} ({kernels} kernels and "
            f"copies), idle {out[route]['idle']} of the host's batch; the "
            f"host issued {calls} kernel launches, graph launches and "
            f"copies a batch; keys {out[route]['keys']}, capture ms "
            f"{out[route]['capture_ms']}; peak device memory "
            f"{peak[route]:.2f} GB; on {card}")
    return graphed, out


def phase_train(card: str, vocab: Path, results: dict):
    """The training path on its two routes from one snapshot of weights and
    moments: the graphed route (the main path, exact launch counts), then
    the uncaptured route, equal to the bit in every metric, parameter and
    moment; each timed. Both run under torch's deterministic algorithms
    (`deterministic`)."""
    cfg = train_config(vocab)
    enc_tok, dec_tok = get_tokenizers(cfg)
    t0 = time.perf_counter()
    module, enc_cfg, dec_cfg = build_model(cfg, enc_tok, dec_tok,
                                           torch.Generator().manual_seed(0))
    log(f"[train] model built in {time.perf_counter() - t0:.1f} s: "
        f"{describe(module, enc_cfg, dec_cfg)}, compute {cfg.compute_dtype}, "
        f"dropout {enc_cfg.hidden_dropout_prob}/"
        f"{enc_cfg.attention_probs_dropout_prob}")
    batch = make_train_batch(cfg, enc_tok, dec_tok, cfg.batch_size)
    micro = as_microbatches(batch, MICRO_BATCHES)
    log(f"[train] {cfg.batch_size} examples as {MICRO_BATCHES} micro-batches "
        f"of {B}: " + ", ".join(f"{k} {v.shape[1:]}"
                                for k, v in micro.items()))
    # a 3-step run: warmup int(3 * 0.02) = 0 steps, then the cosine decay
    optimizer = make_optimizer(cfg, TRAIN_STEPS, module.named_parameters())
    names = [n for n, _ in module.named_parameters()]
    start = train_snapshot(module, optimizer)
    fresh = {"count": 0, "moments": {}}   # moments zero, no update made

    runs = {}
    for route in ("cuda_graphs", "uncaptured"):
        with torch.no_grad():
            for p, p0 in zip(module.parameters(), start["params"]):
                p.copy_(p0)
        optimizer.load_state_dict(fresh)
        with deterministic():
            runs[route] = run_route(route, module, cfg, optimizer,
                                    dec_tok.pad_token_id, micro,
                                    TrainState.create(module, optimizer))
    graphed, uncaptured = runs["cuda_graphs"], runs["uncaptured"]

    enc_layers, dec_layers = (enc_cfg.num_hidden_layers,
                              dec_cfg.num_hidden_layers)
    per_mb = {"fused_attention_fwd": enc_layers,
              "fused_attention_bwd": enc_layers,
              "fused_layernorm_fwd": 2 * enc_layers + 3 * dec_layers,
              "fused_layernorm_bwd": 2 * enc_layers + 3 * dec_layers}
    expected = {k: v * MICRO_BATCHES * TRAIN_STEPS for k, v in per_mb.items()}
    for route, run in runs.items():
        counts = dict(run["counts"])
        if any([counts.pop(name) for name in (*TOPK_LAYOUTS.values(),
                                              *CAUSAL_KERNELS,
                                              "grouped_decode_attn")]):
            raise AssertionError("training launched a retrieval, causal or "
                                 "decode kernel")
        log(f"[train] {route}: launches over {TRAIN_STEPS} steps x "
            f"{MICRO_BATCHES} micro-batches: {counts} (per micro-batch "
            f"{per_mb})")
        if counts != expected:
            raise AssertionError(f"{route}: launches {counts}, expected "
                                 f"{expected}")
        if route == "cuda_graphs":
            for name, n in counts.items():
                results[name]["launches"] = n

    # the two routes from one snapshot: equal to the bit
    unequal = [f"step {i + 1} {k}"
               for i, (a, b) in enumerate(zip(graphed["history"],
                                              uncaptured["history"]))
               for k in a if not torch.equal(a[k], b[k])]
    diff = differing(graphed["end"], uncaptured["end"], names)
    unequal += list(diff)
    log(f"[train] graphed route against the uncaptured route from one "
        f"snapshot, {TRAIN_STEPS} steps, under torch's deterministic "
        f"algorithms: "
        + ("every metric, parameter and moment equal to the bit"
           if not unequal else
           f"DIFFERENT: {unequal[:10]} ({ {k: f'{d:.2e}' for k, d in diff.items()} })"))
    if unequal:
        raise AssertionError(f"the graphed train step departs from the "
                             f"uncaptured one: {unequal[:10]}")
    history = [{k: float(v) for k, v in h.items()}
               for h in graphed["history"]]
    for h in history:
        if not all(np.isfinite(v) for v in h.values()):
            raise AssertionError(f"non-finite metric: {h}")
        if not h["grad_norm"] > 0.0:
            raise AssertionError(f"grad_norm {h['grad_norm']}")
    if not history[-1]["train_loss"] < history[0]["train_loss"]:
        raise AssertionError(f"the loss did not fall: {history}")
    changed = sum(int(not torch.equal(a, b)) for a, b in zip(
        start["params"], graphed["end"]["params"]))
    if changed != len(names):
        raise AssertionError(f"only {changed} of {len(names)} parameter "
                             f"tensors changed")
    del start, graphed["end"], uncaptured["end"]

    with deterministic():
        timing = {route: route_timing(card, run, micro, cfg, per_mb)
                  for route, run in runs.items()}
    results["train_routes"] = timing
    # the eval step on its two routes, the four micro-batches in turn
    batches = [{k: v[i] for k, v in micro.items()}
               for i in range(MICRO_BATCHES)]
    eval_step, results["eval"]["rcr"] = eval_routes(
        card, "train", module, cfg, dec_tok.pad_token_id, batches,
        {"fused_attention_fwd": enc_layers,
         "fused_layernorm_fwd": 2 * enc_layers + 3 * dec_layers}, results)
    out = eval_step(batches[0])
    loss, acc = out["loss"].float().cpu(), out["acc"].float().cpu()
    if loss.shape != (B,) or acc.shape != (B,) or not bool(
            torch.isfinite(loss).all()):
        raise AssertionError("eval step")
    log(f"[train] eval step on micro-batch 0: mean loss "
        f"{float(loss.mean()):.4f}, greedy exact match "
        f"{float(acc.mean()):.3f}")
    med = timing["cuda_graphs"]["host_ms"]
    log(f"[train] {med:.1f} ms per optimizer step on the graphed route "
        f"(host clock) = {cfg.batch_size / med * 1e3:.1f} examples/s for "
        f"{MICRO_BATCHES} x {B} examples at L={L}, bf16 compute, f32 "
        f"parameters, dropout {DROPOUT_P}, on {card}; uncaptured "
        f"{timing['uncaptured']['host_ms']:.1f} ms")
    return cfg, enc_tok, dec_tok, micro, med


def small_configs(tmp: Path, layers: int):
    """The two presets cut to `layers` layers, full width, as json files."""
    paths = []
    for name in ("scibert_base", "bert_l6"):
        path = tmp / f"{name}_{layers}.json"
        path.write_text(json.dumps(dataclasses.asdict(
            PRESETS[name].replace(num_hidden_layers=layers))))
        paths.append(str(path))
    return paths


def phase_train_pad_microbatch(cfg, enc_tok, dec_tok, micro, tmp: Path):
    """3 real micro-batches + 1 weight-0 pad give the update of 3 real ones
    (2 + 2 layers at full width, f32, no dropout: a cheap run)."""
    enc_json, dec_json = small_configs(tmp, 2)
    cfg = dataclasses.replace(cfg, encoder=enc_json, decoder=dec_json,
                              compute_dtype="float32")
    params = []
    for micro_n, weights in ((micro, [1, 1, 1, 0]),
                             ({k: v[:3] for k, v in micro.items()},
                              [1, 1, 1])):
        module, _, _ = build_model(cfg, enc_tok, dec_tok,
                                   torch.Generator().manual_seed(0))
        set_dropout(module, 0.0)
        optimizer = make_optimizer(cfg, TRAIN_STEPS, module.named_parameters())
        step = make_accum_train_step(module, cfg, optimizer,
                                     dec_tok.pad_token_id)
        state, metrics = step(TrainState.create(module, optimizer), micro_n,
                              weights, cfg.seed)
        params.append(([p.detach() for p in module.parameters()],
                       float(metrics["train_loss"])))
    # not bit for bit: the embedding tables' gradients are scatter-adds
    # with float atomics in torch, whose order varies from run to run
    diff = max(float((a - b).abs().max())
               for a, b in zip(params[0][0], params[1][0]))
    log(f"[train] weight-0 pad micro-batch: loss {params[0][1]:.6f} vs "
        f"{params[1][1]:.6f}, parameters after the update differ by at most "
        f"{diff:.3e} (bound {PAD_BOUND:g}, a hundredth of the learning "
        f"rate)")
    if not (diff <= PAD_BOUND
            and abs(params[0][1] - params[1][1]) <= PAD_BOUND):
        raise AssertionError("a weight-0 micro-batch changed the update")


def phase_train_kernels_vs_plain(cfg, enc_tok, dec_tok, micro,
                                 pad_id: int, tag: str = "train") -> None:
    """One micro-batch of 8 examples of `cfg`'s model in f32 without
    dropout: loss and every gradient, kernels (and the routes past the
    recipes' shapes) against plain functions."""
    n = 8
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    module, _, _ = build_model(cfg, enc_tok, dec_tok,
                               torch.Generator().manual_seed(0))
    set_dropout(module, 0.0)
    module.train()
    loss_fn = make_loss_fn(module, cfg, pad_id)
    batch = to_device({k: v[0][:n] for k, v in micro.items()},
                      torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = []
    for on in (True, False):
        set_kernels(module, on)
        module.zero_grad(set_to_none=True)
        before = read_counts(), read_route_counts()
        loss, _ = loss_fn(batch, gen)
        loss.backward()
        torch.cuda.synchronize()
        launched = (read_counts(), read_route_counts()) != before
        if launched != on:
            raise AssertionError(f"kernels on={on} but launched={launched}")
        runs.append((float(loss.detach()), {name: p.grad.clone() for name, p
                                   in module.named_parameters()}))
    (loss_k, grads_k), (loss_p, grads_p) = runs
    enc = module.encoder.config
    # A tensor's difference is held against its own largest gradient, but
    # not against less than GRAD_FLOOR of the largest gradient of all: the
    # attention key biases have a gradient of exactly zero (a softmax does
    # not see a shift of all its scores), so what they hold is rounding
    # noise on both sides
    floor = TRAIN_GRAD_FLOOR * max(float(g.abs().max())
                                   for g in grads_p.values())
    worst, worst_name, worst_abs = 0.0, "", 0.0
    for name, g in grads_p.items():
        diff = float((grads_k[name] - g).abs().max())
        rel = diff / max(float(g.abs().max()), floor)
        if rel > worst:
            worst, worst_name, worst_abs = rel, name, diff
    log(f"[{tag}] kernels vs plain functions, f32, p=0, {n} examples at "
        f"L={L}, encoder {enc.num_hidden_layers} x {enc.hidden_size} in "
        f"{enc.num_attention_heads} heads: loss {loss_k:.6f} vs {loss_p:.6f} "
        f"(bound {TRAIN_LOSS_BOUND:g}); worst gradient tensor {worst_name}: "
        f"max abs diff {worst_abs:.3e}, over max(its max abs, {floor:.3e}) "
        f"= {worst:.3e} (bound {TRAIN_GRAD_BOUND:g}) over {len(grads_p)} "
        f"tensors; the plain pass launched no kernel")
    if not (abs(loss_k - loss_p) <= TRAIN_LOSS_BOUND
            and worst <= TRAIN_GRAD_BOUND):
        raise AssertionError("training with kernels departs from the plain "
                             "path")


def sparse_counts(rng, n: int, d: int, nnz: int) -> np.ndarray:
    """n int8 rows with about `nnz` non-zero entries in -3..3 each, as
    reaction difference fingerprints have."""
    out = np.zeros((n, d), np.int8)
    cols = rng.integers(0, d, (n, nnz))
    vals = (rng.integers(1, 4, (n, nnz))
            * rng.choice([-1, 1], (n, nnz))).astype(np.int8)
    out[np.arange(n)[:, None], cols] = vals
    return out


def topk_both_layouts(tag, queries, corpus, n_real, banned, k) -> None:
    """Both layouts of exact_topk_l2 on the card against the plain version
    on the card and the numpy oracle on the host: equal, tolerance 0."""
    norms = topk.corpus_norms_padded(corpus, n_real)
    q, c, n = (torch.from_numpy(a).cuda() for a in (queries, corpus, norms))
    b = None if banned is None else torch.from_numpy(banned).cuda()
    ref_v, ref_i = topk.exact_topk_l2_reference(q, c, n, b, k=k)
    for resident, name in TOPK_LAYOUTS.items():
        vals, idx = topk.exact_topk_l2(q, c, n, b, k=k,
                                       corpus_resident=resident)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ref_i) and torch.equal(vals, ref_v)):
            raise AssertionError(f"{tag}: {name} disagrees with its plain "
                                 f"version")
    nb = 0 if banned is None else banned.shape[1]
    oracle = "not comparable (fewer rows than k)"
    if n_real >= k + nb:
        o_v, o_i = topk.numpy_reference_topk(queries, corpus[:n_real], k,
                                             banned)
        if not (np.array_equal(ref_i.cpu().numpy(), o_i)
                and np.array_equal(ref_v.cpu().numpy(), o_v)):
            raise AssertionError(f"{tag}: the plain version disagrees with "
                                 f"the numpy oracle")
        oracle = "equal"
    log(f"  top-k {tag}: both layouts equal the plain version exactly "
        f"(tolerance 0); numpy oracle: {oracle}")


def kernels_topk_small() -> None:
    log("[kernels] exact top-k L2, small shapes, both layouts")
    rng = np.random.default_rng(0)
    # (M, N, d, kind, k, NB)
    cases = [(37, 601, 128, "binary", 20, 0), (130, 1000, 1024, "binary", 5, 0),
             (257, 3001, 2048, "counts", 20, 3), (5, 129, 256, "full", 100, 0),
             (128, 128, 2048, "full", 1, 1), (9, 7, 128, "binary", 20, 0),
             (300, 5000, 1024, "counts", 100, 1),
             (64, 2000, 2048, "full", 20, 0),
             # k past INSERT_K: items of 64 queries merging runs, the lists
             # in shared memory up to 339 and in device memory past it,
             # fewer rows than k among them
             (37, 601, 128, "binary", LARGE_K, 0),
             (130, 3000, 1024, "counts", topk.MAX_K, 2),
             (5, 200, 256, "full", LARGE_K, 0),
             (300, 5000, 2048, "binary", LARGE_K, 1),
             (70, 1500, 256, "counts", 339, 1),
             (70, 1500, 128, "binary", 340, 0)]
    for M, N, d, kind, k, nb in cases:
        if kind == "binary":
            corpus = (rng.random((N, d)) < 0.08).astype(np.int8)
        elif kind == "counts":  # negative counts
            corpus = sparse_counts(rng, N, d, 48)
        else:
            corpus = rng.integers(-127, 128, (N, d)).astype(np.int8)
        # duplicate rows: equal distances across tile and slab boundaries
        corpus[rng.integers(0, N, N // 3)] = corpus[rng.integers(0, N, N // 3)]
        rows = rng.integers(0, N, M)
        queries = corpus[rows].copy()
        queries[::3] = np.roll(queries[::3], 1, axis=1)
        banned = None
        if nb:
            banned = rng.integers(-1, N, (M, nb)).astype(np.int32)
            banned[:, 0] = rows  # masked self-retrieval
        topk_both_layouts(f"M={M} N={N} d={d} {kind} k={k} NB={nb}", queries,
                          corpus, N, banned, k)


def retrieval_data(shape: str):
    """(corpus, queries, banned) of one of the two retrieval shapes, from a
    seed, with numpy on the host."""
    rng = np.random.default_rng(20240229)
    if shape == "bench":  # bench.py of the JAX package: 1024-bit Morgan
        n, d = 200_000, 1024
        corpus = (rng.random((n, d), dtype=np.float32) < 0.08).astype(np.int8)
        queries = (rng.random((TOPK_M, d), dtype=np.float32) < 0.08
                   ).astype(np.int8)
        return corpus, queries, None
    # scripts/train_RCR.sh: reaction difference fingerprints of the train set
    n, d = 700_000, 2048
    corpus = sparse_counts(rng, n, d, 48)
    dup = rng.choice(n, n // 50, replace=False)  # 2% of the rows: real ties
    corpus[dup] = corpus[rng.integers(0, n, len(dup))]
    ids = np.sort(rng.choice(n, TOPK_M, replace=False)).astype(np.int32)
    return corpus, corpus[ids].copy(), ids[:, None].copy()


def library_topk(q, corpus, norms, k, chunk: int = 1024):
    """Yardstick, timed only and used nowhere in the port: the int8 product
    of the library (torch._int_mm) in query chunks, the distances, and
    torch.topk (which has no tie order). Banned ids are not applied."""
    vals, idx = [], []
    ct = corpus.T
    for m0 in range(0, q.shape[0], chunk):
        dist = norms[None, :] - 2 * torch._int_mm(q[m0:m0 + chunk], ct)
        v, i = torch.topk(dist, k, dim=1, largest=False)
        vals.append(v)
        idx.append(i)
    return torch.cat(vals), torch.cat(idx)


def phase_retrieval(card: str, results: dict) -> None:
    k = TOPK_K
    for name in TOPK_LAYOUTS.values():
        results[name] = dict(launches=0)
    built = ptxas_report("exact_topk")
    for kernel, (regs, spill) in sorted(built.items()):
        log(f"[retrieve] {kernel[:60]}: {regs} registers, {spill}")
    largest = topk.INSERT_K   # the largest k of this route
    plan, plan_max = topk.scan_shared(k), topk.scan_shared(largest)
    log(f"[retrieve] topk_scan: {plan.shared_bytes} bytes of dynamic shared "
        f"memory at k={k} ({plan.stages} ring stages, {plan.queries} queries "
        f"a work item), {plan_max.shared_bytes} at k={largest} "
        f"({plan_max.stages}); "
        f"{'built in this process' if built else 'cached build: no report'}")
    for shape in ("bench", "rcr"):
        t0 = time.perf_counter()
        corpus, queries, banned = retrieval_data(shape)
        N, d = corpus.shape
        M = len(queries)
        index = FlatIndex(corpus)
        torch.cuda.synchronize()
        log(f"[retrieve] {shape} shape: corpus {N} x {d} int8 "
            f"({corpus.nbytes / 1e9:.2f} GB on {index.device}), {M} queries, "
            f"k={k}, banned ids: {banned is not None}; default layout "
            f"corpus_resident={index.corpus_resident}; data and index in "
            f"{time.perf_counter() - t0:.1f} s")

        # the main path: one FlatIndex.search per layout
        reset_counts()
        found = {}
        for resident in TOPK_LAYOUTS:
            index.corpus_resident = resident
            found[resident] = index.search(queries, k=k, banned=banned)
        counts = read_counts()
        log(f"[retrieve] {shape}: launches of one search per layout: "
            f"{ {n: counts[n] for n in TOPK_LAYOUTS.values()} }")
        for name in TOPK_LAYOUTS.values():
            if counts[name] != 1:
                raise AssertionError(f"{shape}: {name} launched "
                                     f"{counts[name]} times, expected 1")
            results[name]["launches"] += counts[name]

        q_dev = torch.from_numpy(queries).cuda()
        b_dev = None if banned is None else torch.from_numpy(banned).cuda()
        plain_v, plain_i = topk.exact_topk_l2_reference(
            q_dev[:256], index.corpus, index.norms,
            None if b_dev is None else b_dev[:256], k=k)
        plain_v, plain_i = plain_v.cpu().numpy(), plain_i.cpu().numpy()
        t0 = time.perf_counter()
        oracle_v, oracle_i = index.reference_search(
            queries[:64], k=k, banned=None if banned is None else banned[:64])
        oracle_s = time.perf_counter() - t0
        ties = float((np.diff(plain_v, axis=1) == 0).mean())
        errs = {}
        for resident, name in TOPK_LAYOUTS.items():
            vals, idx = found[resident]
            if vals.shape != (M, k) or idx.shape != (M, k):
                raise AssertionError(f"{shape} {name}: shapes {vals.shape}")
            if not (idx.min() >= 0 and idx.max() < N):
                raise AssertionError(f"{shape} {name}: an index outside the "
                                     f"corpus")
            if not (np.diff(vals.astype(np.int64), axis=1) >= 0).all():
                raise AssertionError(f"{shape} {name}: distances not sorted")
            if banned is not None and (idx == banned).any():
                raise AssertionError(f"{shape} {name}: a banned id came back")
            errs[name] = float(np.abs(vals[:256].astype(np.int64)
                                      - plain_v).max())
            if not (np.array_equal(idx[:256], plain_i)
                    and np.array_equal(vals[:256], plain_v)):
                raise AssertionError(f"{shape} {name} disagrees with the "
                                     f"plain version")
            if not (np.array_equal(idx[:64], oracle_i)
                    and np.array_equal(vals[:64], oracle_v)):
                raise AssertionError(f"{shape} {name} disagrees with the "
                                     f"numpy oracle")
        if not all(np.array_equal(a, b)
                   for a, b in zip(found[True], found[False])):
            raise AssertionError(f"{shape}: the two layouts disagree")
        log(f"[retrieve] {shape}: both layouts equal the plain version on "
            f"the card (256 queries), the numpy oracle ({oracle_s:.1f} s for "
            f"64 queries) and each other (all {M}), tolerance 0; "
            f"{ties:.3f} of neighbouring distances tie")

        time_retrieval(card, results, shape, index, queries, banned, q_dev,
                       b_dev, errs)
        del index, q_dev, b_dev, corpus
        torch.cuda.empty_cache()


def ptxas_report(library: str) -> dict:
    """{kernel: (registers, the spill line)} from the build's -Xptxas -v
    output, for the kernels compiled in this process."""
    report, name = {}, None
    for line in _build.BUILD_LOG.get(library, "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            spill = line.strip()
        elif name and "Used " in line and " registers" in line:
            report[name] = (int(line.split("Used ")[1].split(" ")[0]), spill)
            name = None
    return report


def device_events(prof):
    """(name, start, end) of every kernel and copy the profiler saw on the
    card. Ranges that the host opened (the optimizer's own annotation) are
    mirrored on the device's track: they are no kernels."""
    events = prof.events()
    host_names = {ev.name for ev in events
                  if ev.device_type != torch.autograd.DeviceType.CUDA}
    return [(ev.name, ev.time_range.start, ev.time_range.end)
            for ev in events
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.name not in host_names]


def device_ms_by_kernel(fn, expect: dict, reps: int = 3,
                        tries: int = 3) -> dict:
    """Device ms per call of the kernels that `fn` launches, from
    torch.profiler's device events over `reps` calls after a warm-up.
    `expect`: {label: (a fragment of the kernel's name, its launches a
    call)}. Returns {label: ms}, but only from a trace in which the profiler
    saw every one of those launches, reps times over; the profiler has lost
    launches here, so a trace that misses one is taken again, `tries` times
    in all, and after that every label reads None: not measured."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # launches queued in the first moments of a trace went
            # unrecorded (a whole 23 ms kernel): let the tracer settle
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(0.1)
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
        events = device_events(prof)
        out = {}
        for label, (fragment, per_call) in expect.items():
            spans = [end - start for name, start, end in events
                     if fragment in name]
            seen[label] = len(spans)
            if len(spans) == per_call * reps:
                out[label] = sum(spans) / reps / 1e3
        if len(out) == len(expect):
            return out
    log(f"  profiler: saw {seen} launches of {reps} calls, expected "
        f"{ {label: n * reps for label, (_, n) in expect.items()} } in "
        f"{tries} traces: not measured")
    return dict.fromkeys(expect)


def fmt_ms(ms, digits: int = 3) -> str:
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


def time_retrieval(card, results, shape, index, queries, banned, q_dev, b_dev,
                   errs) -> None:
    k = TOPK_K
    N, d = index.corpus.shape
    M = len(queries)
    ops = 2.0 * M * N * d
    nbytes = N * d + M * d + 8 * M * k
    bound_ms, bound_by = bound(nbytes, ops, torch.int8)

    plain_ms = time_ms(lambda: topk.exact_topk_l2_reference(
        q_dev, index.corpus, index.norms, b_dev, k=k), reps=1)
    library_ms = time_ms(lambda: library_topk(q_dev, index.corpus,
                                              index.norms, k), reps=3)
    torch.cuda.empty_cache()
    log(f"[retrieve] {shape}: {ops / 1e15:.3f} Pop, {nbytes / 1e6:.1f} MB "
        f"→ bound {bound_ms:.3f} ms ({bound_by}); plain version "
        f"{plain_ms:.1f} ms; library (torch._int_mm + torch.topk) "
        f"{library_ms:.2f} ms")
    for resident, name in TOPK_LAYOUTS.items():
        index.corpus_resident = resident
        ms = time_ms(lambda: topk.exact_topk_l2(
            q_dev, index.corpus, index.norms, b_dev, k=k,
            corpus_resident=resident), reps=10)
        host_ms = wall_ms(lambda: index.search(queries, k=k, banned=banned))
        parts = device_ms_by_kernel(
            lambda: topk.exact_topk_l2(q_dev, index.corpus, index.norms,
                                       b_dev, k=k, corpus_resident=resident),
            {"scan": ("topk_scan", 1),
             "merge": ("topk_merge", 1 if resident else 0)})
        log(f"[retrieve] {shape} {name}: device {ms:.3f} ms = "
            f"{M / ms * 1e3:.0f} queries/s, {ops / ms / 1e9:.1f} TOP/s "
            f"({bound_ms / ms * 100:.1f}% of the operations bound "
            f"{bound_ms:.3f} ms); library {library_ms:.2f} ms; profiler: "
            f"scan {fmt_ms(parts['scan'])}, merge {fmt_ms(parts['merge'])}; "
            f"FlatIndex.search numpy in to numpy out {host_ms:.2f} ms = "
            f"{M / host_ms * 1e3:.0f} queries/s; on {card}")
        timing = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by,
                      library_ms=library_ms, search_wall_ms=host_ms,
                      **{f"{label}_ms": v for label, v in parts.items()
                         if v is not None})
        if shape == "rcr":  # the recipe's shape is the kernels' line
            results[name].update(timing)
        else:
            results[name].update({f"{key}_bench": v
                                  for key, v in timing.items()})


def shapes_model(tmp: Path, vocab: Path):
    """(cfg, tokenizers, module) of the recipe's training configuration on
    2 + 2 layers of SHAPES_HIDDEN in PAD_HEADS heads of PAD_DIM: every
    attention call runs below the kernels' width, every residual LN on the
    wide route."""
    paths = []
    for name in ("scibert_base", "bert_l6"):
        path = tmp / f"shapes_{name}.json"
        path.write_text(json.dumps(dataclasses.asdict(PRESETS[name].replace(
            hidden_size=SHAPES_HIDDEN, num_hidden_layers=2,
            num_attention_heads=PAD_HEADS))))
        paths.append(str(path))
    cfg = dataclasses.replace(train_config(vocab), encoder=paths[0],
                              decoder=paths[1])
    enc_tok, dec_tok = get_tokenizers(cfg)
    module, _, _ = build_model(cfg, enc_tok, dec_tok,
                               torch.Generator().manual_seed(0))
    return cfg, enc_tok, dec_tok, module


def phase_shapes(card: str, tmp: Path, vocab: Path, results: dict) -> None:
    """The routes of the shapes past the recipes', through the entry points
    a user calls, with exact launch counts: one training step of a model
    with heads of 96 and rows of 1536 (build_model, make_accum_train_step),
    a training pass of two causal blocks with heads of 96, FlatIndex.search
    at k = 256 in both layouts; then the large-k scan against the plain
    version and the numpy oracle and timed, at the bench shape, at k = 256
    and 1024 (time_largest_k), with the scan's plan for each."""
    cfg, enc_tok, dec_tok, module = shapes_model(tmp, vocab)
    micro = as_microbatches(
        make_train_batch(cfg, enc_tok, dec_tok, SHAPES_BATCH), 1)
    optimizer = make_optimizer(cfg, 1, module.named_parameters())
    step = make_accum_train_step(module, cfg, optimizer, dec_tok.pad_token_id)
    state = TrainState.create(module, optimizer)
    reset_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, micro, np.ones(1, np.float32), cfg.seed)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    routes, main = read_route_counts(), read_counts()
    layers = 2
    want = dict.fromkeys(routes, 0)
    want.update(fused_attention_fwd_padded=layers,
                fused_attention_bwd_padded=layers,
                fused_layernorm_fwd_wide=2 * layers + 3 * layers,
                fused_layernorm_bwd_wide=2 * layers + 3 * layers)
    metrics = {k: float(v) for k, v in metrics.items()}
    if routes != want or any(main.values()) or not all(
            np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"shapes training step: launches {routes} "
                             f"(expected {want}), {main}; {metrics}")
    launches = dict(routes)
    log(f"[shapes] one training step of {SHAPES_BATCH} examples at L={L}, "
        f"2 + 2 layers of {SHAPES_HIDDEN} in {PAD_HEADS} heads of {PAD_DIM}, "
        f"bf16, dropout {DROPOUT_P}, MLM: {metrics}, {step_ms:.1f} ms (host "
        f"clock, first step); launches {routes}")
    del module, state, optimizer, step
    torch.cuda.empty_cache()
    # the same model and batch in f32 without dropout: loss and every
    # gradient through the routes against the plain functions
    phase_train_kernels_vs_plain(cfg, enc_tok, dec_tok, micro,
                                 dec_tok.pad_token_id, "shapes")
    del micro
    torch.cuda.empty_cache()

    config = PRESETS["bert_l6"].replace(num_attention_heads=CAUSAL_PAD_HEADS,
                                        attention_impl="flash",
                                        layernorm_impl="fused")
    stack = CausalStack(config, torch.bfloat16, layers=layers).cuda().train()
    x, enc, cross_bias, self_mask, w = causal_inputs(L, SHAPES_BATCH,
                                                     torch.bfloat16, 5)
    xg = x.clone().requires_grad_()
    reset_counts()
    out = stack(xg, enc, cross_bias, self_mask,
                generator=torch.Generator(device="cuda").manual_seed(5))
    (out.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    routes = read_route_counts()
    want = dict.fromkeys(routes, 0)
    want.update(causal_attention_fwd_padded=layers,
                causal_attention_bwd_padded=layers)
    if routes != want or not bool(torch.isfinite(xg.grad).all()):
        raise AssertionError(f"causal blocks with heads of {PAD_DIM}: "
                             f"launches {routes}, expected {want}")
    for name in ("causal_attention_fwd_padded", "causal_attention_bwd_padded"):
        launches[name] = routes[name]
    log(f"[shapes] {layers} causal blocks of {HIDDEN} in "
        f"{config.num_attention_heads} heads of {PAD_DIM}, B={SHAPES_BATCH} "
        f"L={L}, "
        f"forward + backward in training mode: launches {routes}")
    del stack, out, xg
    torch.cuda.empty_cache()

    corpus, queries, _ = retrieval_data("bench")
    index = FlatIndex(corpus)
    N, d = index.corpus.shape
    M, k = len(queries), LARGE_K
    reset_counts()
    found = {}
    for resident in TOPK_LAYOUTS:
        index.corpus_resident = resident
        found[resident] = index.search(queries, k=k)
    routes = read_route_counts()
    want = dict.fromkeys(routes, 0)
    want.update(exact_topk_corpus_split_large_k=1,
                exact_topk_query_outer_large_k=1)
    if routes != want or any(read_counts().values()):
        raise AssertionError(f"FlatIndex.search k={k}: launches {routes}")
    for name in ("exact_topk_corpus_split_large_k",
                 "exact_topk_query_outer_large_k"):
        launches[name] = routes[name]
    q_dev = torch.from_numpy(queries).cuda()
    plain_v, plain_i = (t.cpu().numpy() for t in topk.exact_topk_l2_reference(
        q_dev[:256], index.corpus, index.norms, k=k))
    oracle_v, oracle_i = index.reference_search(queries[:64], k=k)
    if not all(np.array_equal(a, b) for a, b in zip(found[True],
                                                    found[False])):
        raise AssertionError(f"k={k}: the two layouts disagree")
    for kk in (k, topk.MAX_K):
        plan = topk.scan_shared(kk)
        log(f"[shapes] the scan's plan at k={kk}: {plan.queries} queries a "
            f"work item, {plan.stages} ring stages, {plan.shared_bytes} bytes "
            f"of shared memory, the lists in "
            f"{'device' if plan.device_lists else 'shared'} memory")
    ops = 2.0 * M * N * d
    bound_ms, bound_by = bound(N * d + M * d + 8 * M * k, ops, torch.int8)
    plain_ms = time_ms(lambda: topk.exact_topk_l2_reference(
        q_dev, index.corpus, index.norms, k=k), reps=1)
    library_ms = time_ms(lambda: library_topk(q_dev, index.corpus,
                                              index.norms, k), reps=3)
    for resident, name in TOPK_LAYOUTS.items():
        vals, idx = found[resident]
        if not (np.array_equal(idx[:256], plain_i)
                and np.array_equal(vals[:256], plain_v)
                and np.array_equal(idx[:64], oracle_i)
                and np.array_equal(vals[:64], oracle_v)):
            raise AssertionError(f"k={k} {name} disagrees with the plain "
                                 f"version or the numpy oracle")
        ms = time_ms(lambda: topk.exact_topk_l2(
            q_dev, index.corpus, index.norms, k=k, corpus_resident=resident),
            reps=5)
        log(f"[shapes] bench shape k={k} {name}: equal to the plain version "
            f"(256 queries) and the numpy oracle (64), tolerance 0; device "
            f"{ms:.3f} ms = {M / ms * 1e3:.0f} queries/s ({bound_ms / ms:.1%} "
            f"of the {bound_by} bound {bound_ms:.3f} ms), plain "
            f"{plain_ms:.1f} ms, library (torch._int_mm + torch.topk) "
            f"{library_ms:.2f} ms; on {card}")
        results[name + "_large_k"] = dict(
            max_abs_err=float(np.abs(vals[:256].astype(np.int64)
                                     - plain_v).max()),
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms)
    time_largest_k(card, results, index, queries, q_dev)
    for name, n in launches.items():
        results[name]["launches"] = n
    del index, q_dev, corpus
    torch.cuda.empty_cache()


def time_largest_k(card, results, index, queries, q_dev) -> None:
    """Both layouts at the largest k (the lists in device memory) on the
    bench data: equal to the plain version (256 queries) and the numpy
    oracle (64), tolerance 0, and timed beside the library's call."""
    k = topk.MAX_K
    N, d = index.corpus.shape
    M = len(queries)
    plain_v, plain_i = (t.cpu().numpy() for t in topk.exact_topk_l2_reference(
        q_dev[:256], index.corpus, index.norms, k=k))
    oracle_v, oracle_i = index.reference_search(queries[:64], k=k)
    bound_ms, bound_by = bound(N * d + M * d + 8 * M * k, 2.0 * M * N * d,
                               torch.int8)
    library_ms = time_ms(lambda: library_topk(q_dev, index.corpus,
                                              index.norms, k), reps=3)
    for resident, name in TOPK_LAYOUTS.items():
        vals, idx = (t.cpu().numpy() for t in topk.exact_topk_l2(
            q_dev, index.corpus, index.norms, k=k, corpus_resident=resident))
        if not (np.array_equal(idx[:256], plain_i)
                and np.array_equal(vals[:256], plain_v)
                and np.array_equal(idx[:64], oracle_i)
                and np.array_equal(vals[:64], oracle_v)):
            raise AssertionError(f"k={k} {name} disagrees with the plain "
                                 f"version or the numpy oracle")
        ms = time_ms(lambda: topk.exact_topk_l2(
            q_dev, index.corpus, index.norms, k=k, corpus_resident=resident),
            reps=3)
        log(f"[shapes] bench shape k={k} {name}: equal to the plain version "
            f"(256 queries) and the numpy oracle (64), tolerance 0; device "
            f"{ms:.3f} ms ({bound_ms / ms:.1%} of the {bound_by} bound "
            f"{bound_ms:.3f} ms), library (torch._int_mm + torch.topk) "
            f"{library_ms:.2f} ms; on {card}")
        results[name + "_large_k"].update(
            ms_k1024=ms, bound_ms_k1024=bound_ms, library_ms_k1024=library_ms)
    # the corpus-split scan on both sides of the plan's two boundaries: the
    # insertion's last k and the merge's first, the last k with the lists
    # in shared memory and the first with them in device memory
    shared = max(kk for kk in range(topk.INSERT_K + 1, k + 1)
                 if not topk.scan_layout(kk).device_lists)
    by_k = {kk: time_ms(lambda: topk.exact_topk_l2(
        q_dev, index.corpus, index.norms, k=kk, corpus_resident=True),
        reps=3) for kk in (topk.INSERT_K, topk.INSERT_K + 1, shared,
                           shared + 1, 512)}
    log(f"[shapes] bench shape corpus-split by k: "
        f"{ {kk: round(ms, 3) for kk, ms in by_k.items()} } ms; on {card}")
    results["exact_topk_corpus_split_large_k"]["ms_by_k"] = by_k


def write_reaction_csvs(root: Path, sizes: dict) -> None:
    """Fixture CSVs of acylations over a few building blocks (so many rows
    are duplicates, as in a reaction database): ids, reaction SMILES, the
    five condition columns and a year."""
    import random
    rng = random.Random(0)
    chlorides = ["CC(=O)Cl", "CCC(=O)Cl", "CC(C)C(=O)Cl", "CCCC(=O)Cl",
                 "c1ccccc1C(=O)Cl", "C1CC1C(=O)Cl", "Fc1ccc(cc1)C(=O)Cl"]
    partners = ["OC", "OCC", "OCc1ccccc1", "NCC", "NC1CCCCC1", "Nc1ccccc1",
                "OC(C)C", "NCCO", "OCCCC"]
    for name, n in sizes.items():
        with open(root / f"{name}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "canonical_rxn", "catalyst1", "solvent1",
                        "solvent2", "reagent1", "reagent2", "year"])
            for i in range(n):
                chloride, partner = rng.choice(chlorides), rng.choice(partners)
                w.writerow([f"{name}_{i}",
                            f"{chloride}.{partner}>>{chloride[:-2]}{partner}",
                            *rng.choice(CONDITIONS),
                            rng.randrange(1990, 2016)])


def phase_retrieval_cli(tmp: Path) -> None:
    """python -m textreact_tpu_torch.retrieval.cli, in-process on the card."""
    data, out = tmp / "retrieval_data", tmp / "retrieval_out"
    data.mkdir()
    sizes = RUNTIME_SIZES
    write_reaction_csvs(data, sizes)
    before = read_counts()
    t0 = time.perf_counter()
    retrieval_cli.main([
        "--data_path", str(data), "--train_file", "train.csv",
        "--valid_file", "val.csv", "--test_file", "test.csv",
        "--field", "canonical_rxn", "--output_path", str(out),
        "--k", str(TOPK_K), "--check_parity"])
    seconds = time.perf_counter() - t0
    launched = sum(read_counts()[n] - before[n]
                   for n in TOPK_LAYOUTS.values())
    if launched != 3:
        raise AssertionError(f"the CLI launched {launched} searches, "
                             f"expected 3")
    fps = np.load(out / "train_fp.npy")
    if fps.shape != (sizes["train"], 2048) or fps.dtype != np.int8:
        raise AssertionError(f"train_fp.npy {fps.shape} {fps.dtype}")
    for name, n in sizes.items():
        records = json.loads((out / f"{name}.json").read_text())
        if len(records) != n or any(len(r["nn"]) != TOPK_K for r in records):
            raise AssertionError(f"{name}.json: {len(records)} records")
        if not all(r["id"] == f"{name}_{i}" and
                   all(x.startswith("train_") for x in r["nn"])
                   for i, r in enumerate(records)):
            raise AssertionError(f"{name}.json: ids")
    log(f"[retrieve] CLI on the card: {sizes} reactions fingerprinted, "
        f"indexed and searched with --check_parity in {seconds:.1f} s, three "
        f"searches launched, every nn list {TOPK_K} long")


class CausalStack(torch.nn.Module):
    """bert_l6's six blocks as causal blocks: TransformerBlock(causal=True)
    with no self bias, the decoder's key mask as `self_mask`, and
    cross-attention over the encoder states under their key bias."""

    def __init__(self, config, dtype, layers=None):
        super().__init__()
        n = config.num_hidden_layers if layers is None else layers
        self.layers = torch.nn.ModuleList(
            TransformerBlock(config, dtype, torch.float32, causal=True)
            for _ in range(n))
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, torch.nn.Linear):
                    m.weight.copy_(torch.empty(m.weight.shape).normal_(
                        0.0, config.initializer_range, generator=gen))
                    m.bias.zero_()

    def forward(self, x, encoder_states, cross_bias, self_mask,
                generator=None):
        for layer in self.layers:
            x = layer(x, self_bias=None, encoder_states=encoder_states,
                      cross_bias=cross_bias, self_mask=self_mask,
                      generator=generator)
        return x


def causal_inputs(n: int, batch: int, dtype, seed: int):
    """Decoder-side activations of length n with a ragged right-padded key
    mask, encoder states of L=512 with theirs, and a cotangent."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    x, w = (torch.randn(batch, n, HIDDEN, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    enc = torch.randn(batch, L, HIDDEN, generator=gen, device=dev).to(dtype)
    lengths = rng.integers(1, n + 1, batch)
    lengths[0] = n
    self_mask = torch.as_tensor(np.arange(n)[None, :] < lengths[:, None],
                                dtype=torch.int32, device=dev)
    enc_lengths = rng.integers(64, L + 1, batch)
    cross_bias = torch.as_tensor(
        np.where(np.arange(L)[None, :] < enc_lengths[:, None], 0.0, -1e9),
        dtype=torch.float32, device=dev)[:, None, None, :]
    return x, enc, cross_bias, self_mask, w


def phase_causal_path(card: str, results: dict) -> None:
    config = PRESETS["bert_l6"].replace(attention_impl="flash",
                                        layernorm_impl="fused")
    n_layers = config.num_hidden_layers
    stack = CausalStack(config, torch.bfloat16).cuda()
    log(f"[causal] {n_layers} x TransformerBlock(causal=True), d="
        f"{config.hidden_size}, {config.num_attention_heads} heads of "
        f"{config.head_dim}, cross-attention over L={L}, "
        f"{sum(p.numel() for p in stack.parameters()) / 1e6:.1f} M f32 "
        f"parameters, bf16 compute, hidden dropout "
        f"{config.hidden_dropout_prob}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    launches = dict.fromkeys(CAUSAL_KERNELS, 0)
    for n in CAUSAL_LENGTHS:
        x, enc, cross_bias, self_mask, w = causal_inputs(
            n, B, torch.bfloat16, seed=n)
        # forward in eval mode
        stack.eval()
        reset_counts()
        with torch.no_grad():
            out = stack(x, enc, cross_bias, self_mask)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {"causal_attention_fwd": n_layers, "causal_attention_bwd": 0,
                "fused_attention_fwd": 0, "fused_attention_bwd": 0,
                "fused_layernorm_fwd": 3 * n_layers,
                "fused_layernorm_bwd": 0}
        if any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"causal eval pass L={n}: launches "
                                 f"{counts}, expected {want}")
        if out.shape != x.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"causal eval pass L={n}: output")
        for name in CAUSAL_KERNELS:
            launches[name] += counts[name]
        with torch.no_grad():
            fwd_ms = wall_ms(lambda: stack(x, enc, cross_bias, self_mask))
        # the same states through the plain functions
        set_kernels(stack, False)
        before = read_counts()
        with torch.no_grad():
            plain = stack(x, enc, cross_bias, self_mask)
        set_kernels(stack, True)
        torch.cuda.synchronize()
        if read_counts() != before:
            raise AssertionError("the plain causal pass launched a kernel")
        diff = float((out.float() - plain.float()).abs().max())
        if not diff <= ENCODER_BOUND["bfloat16"]:
            raise AssertionError(f"causal stack L={n}: kernels depart from "
                                 f"the plain path by {diff:.3e}")

        # forward + backward in training mode: hidden dropout through the
        # residual-LN kernel, no attention dropout on the causal branch
        stack.train()
        stack.zero_grad(set_to_none=True)
        xg = x.clone().requires_grad_()
        reset_counts()
        out = stack(xg, enc, cross_bias, self_mask, generator=gen)
        (out.float() * w.float()).sum().backward()
        torch.cuda.synchronize()
        counts = read_counts()
        want = {"causal_attention_fwd": n_layers,
                "causal_attention_bwd": n_layers,
                "fused_attention_fwd": 0, "fused_attention_bwd": 0,
                "fused_layernorm_fwd": 3 * n_layers,
                "fused_layernorm_bwd": 3 * n_layers}
        if any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"causal training pass L={n}: launches "
                                 f"{counts}, expected {want}")
        grads = [xg.grad] + [p.grad for p in stack.parameters()]
        if not all(g is not None and bool(torch.isfinite(g).all())
                   for g in grads) or not float(xg.grad.abs().max()) > 0:
            raise AssertionError(f"causal training pass L={n}: gradients")
        for name in CAUSAL_KERNELS:
            launches[name] += counts[name]

        def train_pass():
            stack.zero_grad(set_to_none=True)
            o = stack(xg, enc, cross_bias, self_mask, generator=gen)
            (o.float() * w.float()).sum().backward()

        train_ms = wall_ms(train_pass)
        log(f"[causal] B={B} L={n}: eval forward {fwd_ms:.1f} ms, training "
            f"forward + backward {train_ms:.1f} ms (host clock, median of "
            f"5) on {card}; launches a pass: causal attention {n_layers} "
            f"forward and {n_layers} backward, residual LN {3 * n_layers} "
            f"and {3 * n_layers}; bf16 eval output, kernels vs plain "
            f"functions: max abs diff {diff:.3e} (bound "
            f"{ENCODER_BOUND['bfloat16']:g})")
    for name in CAUSAL_KERNELS:
        results[name]["launches"] = launches[name]

    # the unaligned length takes the plain path: no causal launch
    x, enc, cross_bias, self_mask, _ = causal_inputs(
        UNALIGNED_LENGTH, B, torch.bfloat16, seed=1)
    stack.eval()
    reset_counts()
    with torch.no_grad():
        out = stack(x, enc, cross_bias, self_mask)
    torch.cuda.synchronize()
    counts = read_counts()
    if (counts["causal_attention_fwd"] or counts["fused_attention_fwd"]
            or counts["fused_layernorm_fwd"] != 3 * n_layers
            or not bool(torch.isfinite(out).all())):
        raise AssertionError(f"causal stack at L={UNALIGNED_LENGTH}: "
                             f"launches {counts}")
    log(f"[causal] L={UNALIGNED_LENGTH} (not a multiple of 128): no causal "
        f"kernel launched, {counts['fused_layernorm_fwd']} residual-LN "
        f"launches, finite output")
    del stack
    torch.cuda.empty_cache()
    phase_causal_kernels_vs_plain(config)


def phase_causal_kernels_vs_plain(config) -> None:
    """The causal stack in f32 without dropout, 8 examples at each length:
    the output and every gradient of a weighted sum of it, kernels against
    plain functions (summation order only)."""
    n_batch = 8
    stack = CausalStack(config, torch.float32).cuda()
    set_dropout(stack, 0.0)
    stack.train()
    for n in CAUSAL_LENGTHS:
        x, enc, cross_bias, self_mask, w = causal_inputs(
            n, n_batch, torch.float32, seed=n + 1)
        runs = []
        for on in (True, False):
            set_kernels(stack, on)
            stack.zero_grad(set_to_none=True)
            xg, eg = x.clone().requires_grad_(), enc.clone().requires_grad_()
            before = read_counts()
            out = stack(xg, eg, cross_bias, self_mask)
            (out * w).sum().backward()
            torch.cuda.synchronize()
            if (read_counts() != before) != on:
                raise AssertionError(f"causal stack, kernels on={on}: "
                                     f"launches {read_counts()}")
            grads = {"x": xg.grad, "encoder_states": eg.grad}
            grads.update({name: p.grad.clone()
                          for name, p in stack.named_parameters()})
            runs.append((out.detach(), grads))
        set_kernels(stack, True)
        (out_k, grads_k), (out_p, grads_p) = runs
        out_diff = float((out_k - out_p).abs().max())
        floor = TRAIN_GRAD_FLOOR * max(float(g.abs().max())
                                       for g in grads_p.values())
        worst, worst_name = 0.0, ""
        for name, g in grads_p.items():
            rel = float((grads_k[name] - g).abs().max()) / max(
                float(g.abs().max()), floor)
            if rel > worst:
                worst, worst_name = rel, name
        log(f"[causal] kernels vs plain functions, f32, p=0, {n_batch} "
            f"examples at L={n}: output max abs diff {out_diff:.3e} (bound "
            f"{ENCODER_BOUND['float32']:g}); worst gradient tensor "
            f"{worst_name}: {worst:.3e} of max(its max abs, {floor:.3e}) "
            f"(bound {TRAIN_GRAD_BOUND:g}) over {len(grads_p)} tensors")
        if not (out_diff <= ENCODER_BOUND["float32"]
                and worst <= TRAIN_GRAD_BOUND):
            raise AssertionError(f"causal stack at L={n}: kernels depart "
                                 f"from the plain path")
    del stack
    torch.cuda.empty_cache()


def write_corpus(path: Path, ids, seed: int = 0) -> None:
    """A corpus row per training reaction: a short heading and a paragraph
    of about 220 words (every fourth one 20), so that three neighbours fill
    an encoder input of 512 tokens."""
    rng = np.random.default_rng(seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "heading_text", "paragraph_text"])
        for i, rid in enumerate(ids):
            n_words = 20 if i % 4 == 3 else 220
            w.writerow([rid, " ".join(rng.choice(WORDS, 3)),
                        " ".join(rng.choice(WORDS, n_words))])


def read_metrics(save: Path) -> list:
    with open(save / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def check_eval_records(tag: str, records: list, batches: int) -> dict:
    """The eval step's records of a command-line run on one card (each
    epoch's timing record and --do_valid's): the graphed route, the keys
    captured and the replays of `batches` validation batches a pass, and
    the seconds of each validation, printed."""
    fit = [r for r in records if "epoch_seconds" in r and "val_seconds" in r]
    valid = [r for r in records if "val_seconds" in r
             and "epoch_seconds" not in r]
    if not fit or len(valid) != 1 or any(
            r["eval_route"] != "cuda_graphs"
            or r["eval_keys"] + r["eval_replays"] != batches * (i + 1)
            for i, r in enumerate(fit)) or valid[0]["eval_route"] != \
            "cuda_graphs" or valid[0]["eval_keys"] + valid[0][
            "eval_replays"] != batches:
        raise AssertionError(f"[{tag}] eval records: {fit} {valid}")
    out = dict(route="cuda_graphs",
               val_seconds=[r["val_seconds"] for r in fit],
               keys=[int(r["eval_keys"]) for r in fit],
               do_valid_seconds=valid[0]["val_seconds"],
               do_valid_keys=int(valid[0]["eval_keys"]))
    log(f"[{tag}] validation on the eval step's graphed route: "
        f"{out['val_seconds']} s each epoch ({batches} batches a pass; "
        f"keys captured by then {out['keys']}), --do_valid "
        f"{out['do_valid_seconds']:.2f} s ({out['do_valid_keys']} keys)")
    return out


def phase_runtime(card: str, tmp: Path, vocab: Path, bare_step_ms: float,
                  results: dict) -> None:
    """python -m textreact_tpu_torch, in-process on the card: train, validate
    and test on the retrieval phase's CSVs and neighbour files, then resume
    for one more epoch."""
    data, nn_dir, save = (tmp / "retrieval_data", tmp / "retrieval_out",
                          tmp / "run")
    sizes = RUNTIME_SIZES
    write_corpus(data / "corpus.csv",
                 [f"train_{i}" for i in range(sizes["train"])])
    accum = MICRO_BATCHES

    def argv(epochs: int) -> list:
        return [
            "--task", "condition", "--do_train", "--do_valid", "--do_test",
            "--data_path", str(data), "--train_file", "train.csv",
            "--valid_file", "val.csv", "--test_file", "test.csv",
            "--corpus_file", str(data / "corpus.csv"),
            "--nn_path", str(nn_dir), "--train_nn_file", "train.json",
            "--valid_nn_file", "val.json", "--test_nn_file", "test.json",
            "--encoder", "scibert_base", "--decoder", "bert_l6",
            "--encoder_tokenizer", "text", "--text_vocab_file", str(vocab),
            "--num_neighbors", "3", "--use_gold_neighbor",
            "--max_length", str(L), "--max_dec_length", str(DEC_LEN),
            "--batch_size", str(B), "--gradient_accumulation_steps",
            str(accum), "--test_batch_size", str(B), "--epochs", str(epochs),
            "--lr", "1e-4", "--warmup", "0.02", "--max_grad_norm", "5",
            "--num_beams", str(BEAMS), "--mlm", "--mlm_layer", "mlp",
            "--mlm_lambda", "0.1", "--compute_dtype", "bfloat16",
            "--save_path", str(save), "--log_every", "1", "--debug"]

    enc_layers = PRESETS["scibert_base"].num_hidden_layers
    dec_layers = PRESETS["bert_l6"].num_hidden_layers
    ln_per_batch = 2 * enc_layers + 3 * dec_layers
    train_mbs = -(-sizes["train"] // B)           # loader batches an epoch
    val_batches = 2 * -(-sizes["val"] // B)       # two corpora a pass
    test_batches = 2 * -(-sizes["test"] // B)

    def check_launches(tag, counts, epochs_run):
        mbs = train_mbs * epochs_run
        evals = val_batches * (epochs_run + 1)    # each epoch + --do_valid
        want = {"fused_attention_fwd": enc_layers * (mbs + evals
                                                     + test_batches),
                "fused_attention_bwd": enc_layers * mbs,
                "fused_layernorm_bwd": ln_per_batch * mbs,
                "causal_attention_fwd": 0, "causal_attention_bwd": 0}
        # a test batch launches 2 * enc_layers residual LNs and 3 *
        # dec_layers a decode step; a trained model may stop early
        ln_floor = (ln_per_batch * (mbs + evals)
                    + test_batches * (2 * enc_layers + 3 * dec_layers))
        ln_ceil = (ln_per_batch * (mbs + evals) + test_batches
                   * (2 * enc_layers + 3 * dec_layers * (DEC_LEN - 1)))
        got = {k: counts[k] for k in want}
        log(f"[runtime] {tag}: launches {counts}")
        if got != want or not (ln_floor <= counts["fused_layernorm_fwd"]
                               <= ln_ceil):
            raise AssertionError(
                f"{tag}: launches {counts}; expected {want} and "
                f"{ln_floor}..{ln_ceil} residual-LN forwards for {mbs} "
                f"micro-batches, {evals} validation and {test_batches} test "
                f"batches")

    # --- first run: 2 epochs
    epochs = 2
    reset_counts()
    t0 = time.perf_counter()
    routes: list = []
    with trainer_routes(routes):
        accuracies = runtime_cli.main(argv(epochs))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    check_launches("first run", counts, epochs)
    for name in ("fused_attention_fwd", "fused_attention_bwd",
                 "fused_layernorm_fwd", "fused_layernorm_bwd"):
        results[name]["launches_runtime"] = counts[name]
    records = read_metrics(save)
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    steps_an_epoch = -(-train_mbs // accum)
    if len(losses) < epochs * steps_an_epoch or not all(
            np.isfinite(v) for v in losses):
        raise AssertionError(f"train_loss records: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    names = sorted(p.name for p in save.iterdir())
    for name in ("best.ckpt", "last.ckpt", "best.meta.json",
                 "last.meta.json", "prediction_test_0.json",
                 "prediction_test_1.json"):
        if name not in names:
            raise AssertionError(f"{name} missing from {names}")
    if any(n.endswith(".tmp") for n in names):
        raise AssertionError(f"an unpublished write was left: {names}")
    for li in (0, 1):
        preds = json.loads((save / f"prediction_test_{li}.json").read_text())
        if sorted(map(int, preds)) != list(range(sizes["test"])) or any(
                len(p["prediction"]) != BEAMS or len(p["score"]) != BEAMS
                for p in preds.values()):
            raise AssertionError(f"prediction_test_{li}.json")
    if len(accuracies) != 2 or any(
            set(a) != {1, 3, 5, 10, 15}
            or not all(0.0 <= v <= 1.0 for v in a.values())
            for a in accuracies):
        raise AssertionError(f"accuracy dicts: {accuracies}")
    val = [r for r in records if "val_acc" in r]
    if len(val) != epochs or "val_acc/1" not in val[-1]:
        raise AssertionError(f"validation records: {val}")
    timing = [r for r in records if "epoch_seconds" in r]
    step_ms = timing[-1]["epoch_seconds"] / timing[-1]["epoch_steps"] * 1e3
    first_ms = timing[0]["epoch_seconds"] / timing[0]["epoch_steps"] * 1e3
    validation = check_eval_records("runtime", records, val_batches)
    write_s = [r for r in records if "save_write_seconds" in r][-1][
        "save_write_seconds"]
    tests = [r for r in records if "test_seconds" in r]
    test_rate = (sum(r["test_examples"] for r in tests)
                 / sum(r["test_seconds"] for r in tests))
    ckpt_gb = (save / "last.ckpt").stat().st_size / 1e9
    log(f"[runtime] train + validate + test through the command line in "
        f"{seconds:.1f} s: {sizes} reactions, {epochs} epochs of "
        f"{steps_an_epoch} optimizer steps ({accum} x {B} at L={L}); "
        f"train_loss {losses[0]:.4f} -> {losses[-1]:.4f}; val_acc "
        f"{val[-1]['val_acc']:.3f} / {val[-1]['val_acc/1']:.3f}; top-1 "
        f"{accuracies[0][1]:.3f} / {accuracies[1][1]:.3f}")
    log(f"[runtime] {step_ms:.1f} ms per optimizer step inside the trainer "
        f"(epoch 2, loader waits included; epoch 1 {first_ms:.1f} ms) "
        f"beside {bare_step_ms:.1f} ms for the bare step on one resident "
        f"batch; saving last.ckpt and best.ckpt of {ckpt_gb:.2f} GB each "
        f"holds the loop {timing[0]['save_blocking_seconds']:.2f} s (a "
        f"copy to the host takes {timing[0]['save_copy_seconds']:.2f} s; "
        f"the second save waits for the first one's write), last.ckpt "
        f"alone {timing[-1]['save_blocking_seconds']:.2f} s; the last write "
        f"takes {write_s:.2f} s in the background; test pass "
        f"{test_rate:.1f} examples/s (beam {BEAMS}, both corpora); on "
        f"{card}")
    results["runtime"] = dict(
        route=check_trainer_route("runtime", routes),
        step_ms=step_ms, bare_step_ms=bare_step_ms,
        save_blocking_s=timing[0]["save_blocking_seconds"],
        save_copy_s=timing[0]["save_copy_seconds"], save_write_s=write_s,
        test_examples_per_s=test_rate, validation=validation)

    # --- the same command with one more epoch resumes
    before = len(records)
    reset_counts()
    t0 = time.perf_counter()
    runtime_cli.main(argv(epochs + 1))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    new = read_metrics(save)[before:]
    resumed = [r for r in new if "resumed_at_epoch" in r]
    if len(resumed) != 1:
        raise AssertionError(f"no resume record: {new[:3]}")
    start = int(resumed[0]["resumed_at_epoch"])
    steps = [r["step"] for r in new if "train_loss" in r]
    ran = [r for r in new if "epoch_seconds" in r]
    # it goes on from the restored step, through the epochs that are left
    # (a shape group left with a partial window adds an unlogged step)
    if (not 1 <= start <= epochs
            or [r["epoch"] for r in ran] != list(range(start, epochs + 1))
            or steps[0] != int(resumed[0]["step"]) + 1
            or any(b <= a for a, b in zip(steps, steps[1:]))
            or len(steps) < steps_an_epoch * len(ran)):
        raise AssertionError(f"resumed at epoch {start}, steps {steps}")
    check_launches("resumed run", read_counts(), epochs + 1 - start)
    meta = json.loads((save / "last.meta.json").read_text())
    if meta["epoch"] != epochs or any(
            p.name.endswith(".tmp") for p in save.iterdir()):
        raise AssertionError(f"after the resumed run: {meta}")
    log(f"[runtime] the same command with --epochs {epochs + 1} resumed "
        f"from {resumed[0]['resumed_from']}.ckpt at epoch {start}, ran "
        f"steps {steps[0]}-{steps[-1]}, validated and tested again in "
        f"{seconds:.1f} s")


# --- the pretrained start (--encoder_pretrained / --decoder_pretrained) ---

# allenai/scibert_scivocab_uncased's config.json; the decoder checkpoint is
# a 6-layer BERT of the same width whose vocab (300) is smaller than the
# condition vocab, so the decoder's word table keeps seeded rows past it
SCIBERT_HF_CONFIG = {
    "architectures": ["BertForMaskedLM"], "model_type": "bert",
    "vocab_size": 31090, "hidden_size": 768, "num_hidden_layers": 12,
    "num_attention_heads": 12, "intermediate_size": 3072,
    "max_position_embeddings": 512, "type_vocab_size": 2,
    "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
    "attention_probs_dropout_prob": 0.1, "layer_norm_eps": 1e-12,
    "initializer_range": 0.02, "pad_token_id": 0}
DECODER_HF_CONFIG = dict(SCIBERT_HF_CONFIG, num_hidden_layers=6,
                         vocab_size=300)
# text with non-ASCII bytes: the C++ tokenizer and chemistry leave it to
# the Python route (tokenizer) or fail to parse it as the Python code does
NON_ASCII = ["naïve café µ-wave heating, 100 °C for 2 h", "C°C", "Cé",
             "c1ccccc1µ", "CCO ", "反应 was stirred", "CC(=O)Cl.OCé"]
_SAFETENSORS_CODES = {torch.float64: "F64", torch.float32: "F32",
                      torch.float16: "F16", torch.int64: "I64",
                      torch.int32: "I32", torch.int8: "I8", torch.uint8: "U8",
                      torch.bool: "BOOL"}
# an HF BERT name (without `bert.`) -> the port's, under encoder/decoder;
# stated here apart from models/import_hf.py, which it checks
_HF_RULES = [
    (r"encoder\.layer\.(\d+)\.attention\.self\.(query|key|value)\.",
     r"layers.\1.attention.\2."),
    (r"encoder\.layer\.(\d+)\.attention\.output\.dense\.",
     r"layers.\1.attention.output."),
    (r"encoder\.layer\.(\d+)\.attention\.output\.LayerNorm\.",
     r"layers.\1.attention_norm."),
    (r"encoder\.layer\.(\d+)\.intermediate\.dense\.",
     r"layers.\1.ffn.intermediate."),
    (r"encoder\.layer\.(\d+)\.output\.dense\.", r"layers.\1.ffn.output."),
    (r"encoder\.layer\.(\d+)\.output\.LayerNorm\.", r"layers.\1.ffn_norm."),
    (r"embeddings\.LayerNorm\.", "embeddings.layer_norm."),
    (r"embeddings\.(word|position|token_type)_embeddings\.weight$",
     r"embeddings.\1_embeddings.weight"),
]
_HF_HEAD_RULES = [
    (r"cls\.predictions\.transform\.dense\.", "lm_head.transform."),
    (r"cls\.predictions\.transform\.LayerNorm\.", "lm_head.transform_norm."),
    (r"cls\.predictions\.bias$", "lm_head.bias"),
]


def hf_bert_tensors(config: dict, seed: int, prefix: str = "",
                    mlm_head: bool = False, std: float = 0.02) -> dict:
    """A BERT checkpoint's tensors in HF's names (with `prefix`), pooler
    and, with `mlm_head`, the MaskedLM head's transform and bias included:
    weights, tables and biases drawn from N(0, std), LayerNorm weights from
    N(1, std), in f32 from `seed`."""
    g = torch.Generator().manual_seed(seed)
    d, ffn = config["hidden_size"], config["intermediate_size"]
    shapes = {
        "embeddings.word_embeddings.weight": (config["vocab_size"], d),
        "embeddings.position_embeddings.weight":
            (config["max_position_embeddings"], d),
        "embeddings.token_type_embeddings.weight":
            (config["type_vocab_size"], d),
        "embeddings.LayerNorm.weight": (d,), "embeddings.LayerNorm.bias": (d,)}
    for i in range(config["num_hidden_layers"]):
        hf = f"encoder.layer.{i}"
        for name, shape in (("attention.self.query", (d, d)),
                            ("attention.self.key", (d, d)),
                            ("attention.self.value", (d, d)),
                            ("attention.output.dense", (d, d)),
                            ("intermediate.dense", (ffn, d)),
                            ("output.dense", (d, ffn))):
            shapes[f"{hf}.{name}.weight"] = shape
            shapes[f"{hf}.{name}.bias"] = shape[:1]
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[f"{hf}.{name}.weight"] = (d,)
            shapes[f"{hf}.{name}.bias"] = (d,)
    shapes.update({"pooler.dense.weight": (d, d), "pooler.dense.bias": (d,)})
    out = {prefix + k: torch.randn(shape, generator=g) * std
           for k, shape in shapes.items()}
    if mlm_head:
        out.update({
            "cls.predictions.transform.dense.weight":
                torch.randn(d, d, generator=g) * std,
            "cls.predictions.transform.dense.bias":
                torch.randn(d, generator=g) * std,
            "cls.predictions.transform.LayerNorm.weight":
                torch.randn(d, generator=g) * std,
            "cls.predictions.transform.LayerNorm.bias":
                torch.randn(d, generator=g) * std,
            "cls.predictions.bias":
                torch.randn(config["vocab_size"], generator=g) * std})
    for k, v in out.items():
        if "LayerNorm.weight" in k:
            v += 1.0
    return out


def write_safetensors(path: Path, tensors: dict,
                      metadata: Optional[dict] = None) -> None:
    """The safetensors layout: an 8-byte little-endian header length, the
    JSON header (padded with spaces to 8 bytes), the tensors' bytes."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _SAFETENSORS_CODES[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata is not None:
        header["__metadata__"] = metadata
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.contiguous().numpy().tobytes())


def write_hf_checkpoint(root: Path, config: dict, tensors: dict,
                        fmt: str) -> None:
    """An HF model directory: config.json and `model.safetensors` (with the
    metadata `save_pretrained` writes) or `pytorch_model.bin`."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(config, indent=2))
    if fmt == "safetensors":
        write_safetensors(root / "model.safetensors", tensors,
                          {"format": "pt"})
    else:
        torch.save(tensors, root / "pytorch_model.bin")


def hf_port_name(part: str, name: str) -> Optional[str]:
    """The port parameter an HF BERT tensor lands in when imported into
    `part` ('encoder' or 'decoder'), or None for a tensor that is not
    imported (the pooler; the MLM head into the encoder)."""
    name = name[len("bert."):] if name.startswith("bert.") else name
    if part == "decoder" and name == "embeddings.word_embeddings.weight":
        return "decoder.word_embedding"
    rules = _HF_RULES + (_HF_HEAD_RULES if part == "decoder" else [])
    for pattern, repl in rules:
        new, n = re.subn("^" + pattern, repl, name)
        if n:
            return f"{part}.{new}"
    return None


def check_pretrained_import(params: dict, seeded: dict, files: dict,
                            read: dict) -> tuple:
    """Every imported parameter equal to the file's tensor to the bit, rows
    past the file's table (and every parameter no file names, such as the
    cross-attention) equal to the seeded initialisation `seeded`, and no
    tensor of a file unread but the pooler's. `params` and `seeded` map the
    port's names to CPU tensors; `files` maps 'encoder'/'decoder' to the
    file's {name: tensor}, `read` to the names the import read. Returns
    (imported, seeded) element counts."""
    covered = {}
    for part, tensors in files.items():
        unread = sorted(k for k in set(tensors) - read[part]
                        if "pooler." not in k)
        if unread:
            raise AssertionError(f"{part}: the import left {unread} unread")
        for name, src in tensors.items():
            port = hf_port_name(part, name)
            if port is None:
                continue
            p = params[port]
            n = min(p.shape[0], src.shape[0])
            if not torch.equal(p[:n], src[:n].to(p.dtype)):
                raise AssertionError(f"{port} differs from {part}'s {name}")
            covered[port] = n
    n_imported = n_seeded = 0
    for name, p in params.items():
        n = covered.get(name, 0)
        if not torch.equal(p[n:], seeded[name][n:]):
            raise AssertionError(f"{name}[{n}:] is not the seeded "
                                 f"initialisation")
        n_imported += p[:n].numel()
        n_seeded += p[n:].numel()
    return n_imported, n_seeded


@contextlib.contextmanager
def trainer_routes(routes: list):
    """Append (the train step's route, the peak device memory of the fit in
    GB) of every Trainer whose fit runs inside to `routes`: the command
    line builds its trainer out of reach."""
    from textreact_tpu_torch.train.trainer import Trainer
    fit = Trainer.fit

    def recorded_fit(self):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            return fit(self)
        finally:
            torch.cuda.synchronize()
            routes.append((self.train_route,
                           torch.cuda.max_memory_allocated() / 1e9))

    Trainer.fit = recorded_fit
    try:
        yield
    finally:
        Trainer.fit = fit


def check_trainer_route(tag: str, routes: list) -> str:
    """The one route the trainers of a run took and each fit's peak device
    memory, printed; on one card "cuda_graphs" (train/graphs.py)."""
    log(f"[{tag}] the trainer's train step route: {[r for r, _ in routes]}; "
        f"peak device memory of each fit (its validation included) "
        f"{[round(gb, 1) for _, gb in routes]} GB")
    if {r for r, _ in routes} != {"cuda_graphs"}:
        raise AssertionError(f"{tag}: trainer routes {routes}")
    return routes[0][0]


@contextlib.contextmanager
def before_fit(check):
    """Run `check(trainer)` when a Trainer's fit starts, before its first
    step: the command line builds and trains its trainer out of reach."""
    from textreact_tpu_torch.train.trainer import Trainer
    fit = Trainer.fit

    def checked_fit(self):
        check(self)
        return fit(self)

    Trainer.fit = checked_fit
    try:
        yield
    finally:
        Trainer.fit = fit


def pretrained_argv(data: Path, nn_dir: Path, vocab: Path, enc_dir: Path,
                    dec_dir: Path, save: Path) -> list:
    """scripts/train_RCR.sh's flags on the runtime phase's data, with both
    halves pretrained: one epoch of 4 x 32 at L=512, then validation."""
    return [
        "--task", "condition", "--do_train",
        "--data_path", str(data), "--train_file", "train.csv",
        "--valid_file", "val.csv", "--test_file", "test.csv",
        "--corpus_file", str(data / "corpus.csv"),
        "--nn_path", str(nn_dir), "--train_nn_file", "train.json",
        "--valid_nn_file", "val.json", "--test_nn_file", "test.json",
        "--encoder", str(enc_dir), "--encoder_pretrained",
        "--decoder", str(dec_dir), "--decoder_pretrained",
        "--encoder_tokenizer", "text", "--text_vocab_file", str(vocab),
        "--num_neighbors", "3", "--use_gold_neighbor", "--shuffle_smiles",
        "--max_length", str(L), "--max_dec_length", str(DEC_LEN),
        "--batch_size", str(B), "--gradient_accumulation_steps",
        str(MICRO_BATCHES), "--test_batch_size", str(B), "--epochs", "1",
        "--lr", "1e-4", "--warmup", "0.02", "--max_grad_norm", "5",
        "--mlm", "--mlm_ratio", "0.15", "--mlm_layer", "mlp",
        "--mlm_lambda", "0.1", "--compute_dtype", "bfloat16",
        "--save_path", str(save), "--log_every", "1", "--debug"]


def check_native_tokenization(cfg: ExperimentConfig) -> dict:
    """Every example of the run's three splits built through the C++
    tokenizer equals the one built through the Python route; the encoder
    inputs' tokenization timed per micro-batch of the training split, both
    routes (the Python route's word cache cold, then warm, as the loader's
    is after its first pass), and the share of inputs with non-ASCII bytes,
    which take the Python route."""
    from textreact_tpu_torch.data import DATASET_CLS
    from textreact_tpu_torch.tokenizers import (JointSmilesTextTokenizer,
                                                WordPieceTokenizer)
    native_tok, dec_tok = get_tokenizers(cfg)
    corpus = read_corpus(cfg.corpus_file)

    def dataset(enc_tok, file, nn_file, split):
        ds = DATASET_CLS[cfg.task](cfg, str(Path(cfg.data_path) / file),
                                   enc_tok, dec_tok, split=split)
        ds.load_corpus(corpus, str(Path(cfg.nn_path) / nn_file))
        return ds

    def python_tok():
        return JointSmilesTextTokenizer(
            WordPieceTokenizer(cfg.text_vocab_file, native=False))

    n_examples = 0
    for file, nn_file, split in ((cfg.train_file, cfg.train_nn_file, "train"),
                                 (cfg.valid_file, cfg.valid_nn_file, "val"),
                                 (cfg.test_file, cfg.test_nn_file, "test")):
        a = dataset(native_tok, file, nn_file, split)
        b = dataset(python_tok(), file, nn_file, split)
        for i in range(len(a)):
            ea, eb = (ds.example(i, example_rng(cfg.seed, 0, i))
                      for ds in (a, b))
            if ea.keys() != eb.keys() or any(
                    np.asarray(ea[k]).tolist() != np.asarray(eb[k]).tolist()
                    for k in ea):
                raise AssertionError(f"{split} example {i}: the C++ "
                                     f"tokenizer's differs from Python's")
        n_examples += len(a)
    for text in NON_ASCII:
        ids = native_tok.text_tokenizer._native.encode(text)
        if text.isascii() or ids is not None:
            raise AssertionError(f"{text!r} took the C++ route")
        if native_tok("CCO", text)["input_ids"] != \
                python_tok()("CCO", text)["input_ids"]:
            raise AssertionError(f"{text!r}: the routes' ids differ")

    # the encoder inputs of the training split, as the loader makes them
    train = dataset(native_tok, cfg.train_file, cfg.train_nn_file, "train")
    inputs = []
    for i in range(len(train)):
        rng = example_rng(cfg.seed, 0, i)
        row = train.data_df.row(i)
        inputs.append((row["canonical_rxn"], train.neighbor_text(i, rng)))
    batches = [inputs[i:i + B] for i in range(0, len(inputs), B)]

    def per_batch_ms(tok) -> float:
        t0 = time.perf_counter()
        for batch in batches:
            for rxn, text in batch:
                tok(rxn, text_pair=text)
        return (time.perf_counter() - t0) * 1e3 / len(batches)

    python = python_tok()
    share = sum(not (r.isascii() and (t or "").isascii())
                for r, t in inputs) / len(inputs)
    return dict(examples_checked=n_examples,
                native_ms=per_batch_ms(native_tok),
                python_cold_ms=per_batch_ms(python),
                python_warm_ms=per_batch_ms(python),
                python_route_share=share,
                words_per_input=statistics.mean(
                    len((t or "").split()) + 1 for _, t in inputs))


def check_native_chem(data: Path) -> dict:
    """The C++ chemistry against the Python route on the run's reactions
    and their molecules (and NON_ASCII): reaction-difference and Morgan
    fingerprints equal to the bit, canonical SMILES equal; each route's
    fingerprinting rate over the reactions."""
    from textreact_tpu_torch.chem import (canonical_smiles,
                                          fingerprint_matrix)
    from textreact_tpu_torch.chem.native import native_canonical_batch
    rxns = [r for name in RUNTIME_SIZES
            for r in read_csv(str(data / f"{name}.csv"))["canonical_rxn"]]
    mols = sorted({m for r in rxns for side in r.split(">>")
                   for m in side.split(".")}) + NON_ASCII
    seconds = {}
    fps = {}
    for native in (True, False):
        t0 = time.perf_counter()
        fps[native] = fingerprint_matrix(rxns, "reaction", native=native)
        seconds[native] = time.perf_counter() - t0
    if not np.array_equal(fps[True], fps[False]):
        raise AssertionError("reaction fingerprints: C++ and Python differ")
    if not np.array_equal(fingerprint_matrix(mols, native=True),
                          fingerprint_matrix(mols, native=False)):
        raise AssertionError("Morgan fingerprints: C++ and Python differ")
    if native_canonical_batch(mols) != [canonical_smiles(m) for m in mols]:
        raise AssertionError("canonical SMILES: C++ and Python differ")
    return dict(reactions=len(rxns), molecules=len(mols),
                native_fps_per_s=len(rxns) / seconds[True],
                python_fps_per_s=len(rxns) / seconds[False])


def phase_pretrained(card: str, tmp: Path, vocab: Path, bare_step_ms: float,
                     results: dict) -> None:
    """python -m textreact_tpu_torch from two local HF checkpoints, in-process
    on the card: a SciBERT-base encoder (model.safetensors, no prefix) and
    a 6-layer BERT decoder (pytorch_model.bin with `bert.` and the MaskedLM
    head), each written here from a seed; the import checked to the bit
    before the first step, one epoch and a validation pass; then the C++
    tokenizer and chemistry against their Python routes on the run's
    inputs, both timed."""
    data, nn_dir = tmp / "retrieval_data", tmp / "retrieval_out"
    enc_dir, dec_dir, save = (tmp / "scibert_hf", tmp / "bert_l6_hf",
                              tmp / "run_pretrained")
    t0 = time.perf_counter()
    files = {"encoder": hf_bert_tensors(SCIBERT_HF_CONFIG, seed=1),
             "decoder": hf_bert_tensors(DECODER_HF_CONFIG, seed=2,
                                        prefix="bert.", mlm_head=True)}
    write_hf_checkpoint(enc_dir, SCIBERT_HF_CONFIG, files["encoder"],
                        "safetensors")
    write_hf_checkpoint(dec_dir, DECODER_HF_CONFIG, files["decoder"], "bin")
    size_gb = sum(p.stat().st_size for d in (enc_dir, dec_dir)
                  for p in d.iterdir()) / 1e9
    log(f"[pretrained] two HF checkpoints of {size_gb:.2f} GB written in "
        f"{time.perf_counter() - t0:.1f} s")

    checked = {}

    def check(trainer) -> None:
        seeded, _, _ = build_model(trainer.cfg, trainer.enc_tokenizer,
                                   trainer.dec_tokenizer, device="cpu")
        params = {k: v.detach().cpu()
                  for k, v in trainer.module.named_parameters()}
        imported, kept = check_pretrained_import(
            params, dict(seeded.named_parameters()), files,
            trainer.pretrained_keys)
        checked.update(imported=imported, seeded=kept,
                       import_ms=trainer.import_seconds * 1e3)

    argv = pretrained_argv(data, nn_dir, vocab, enc_dir, dec_dir, save)
    reset_counts()
    t0 = time.perf_counter()
    with before_fit(check):
        runtime_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    if not checked:
        raise AssertionError("the trainer's fit never started")
    enc_layers = SCIBERT_HF_CONFIG["num_hidden_layers"]
    dec_layers = DECODER_HF_CONFIG["num_hidden_layers"]
    mbs = -(-RUNTIME_SIZES["train"] // B)
    evals = 2 * -(-RUNTIME_SIZES["val"] // B)   # two corpora
    ln = 2 * enc_layers + 3 * dec_layers
    want = {"fused_attention_fwd": enc_layers * (mbs + evals),
            "fused_attention_bwd": enc_layers * mbs,
            "fused_layernorm_fwd": ln * (mbs + evals),
            "fused_layernorm_bwd": ln * mbs,
            "causal_attention_fwd": 0, "causal_attention_bwd": 0}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"launches {got}, expected {want}")
    for name in ("fused_attention_fwd", "fused_attention_bwd",
                 "fused_layernorm_fwd", "fused_layernorm_bwd"):
        results[name]["launches_pretrained"] = counts[name]
    records = read_metrics(save)
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    val = [r for r in records if "val_acc" in r]
    timing = [r for r in records if "epoch_seconds" in r]
    if len(losses) != -(-mbs // MICRO_BATCHES) or not all(
            np.isfinite(v) for v in losses) or len(val) != 1:
        raise AssertionError(f"records: {records}")
    step_ms = timing[0]["epoch_seconds"] / timing[0]["epoch_steps"] * 1e3
    log(f"[pretrained] the import checked before the first step: "
        f"{checked['imported'] / 1e6:.1f} M elements equal to the files' to "
        f"the bit, {checked['seeded'] / 1e6:.1f} M (cross-attention, MLM "
        f"head, the decoder's word rows past 300) equal to the seeded "
        f"initialisation, nothing unread but the poolers; import "
        f"{checked['import_ms']:.0f} ms")
    log(f"[pretrained] the command line with --encoder_pretrained "
        f"--decoder_pretrained in {seconds:.1f} s: train_loss "
        f"{', '.join(f'{v:.4f}' for v in losses)}; val_acc "
        f"{val[0]['val_acc']:.3f}; {step_ms:.1f} ms per optimizer step "
        f"(epoch 1, its first step and the loader's waits included) beside "
        f"{bare_step_ms:.1f} ms for the bare step; launches {got}")

    cfg = runtime_cli.parse_config(argv)
    tok = check_native_tokenization(cfg)
    log(f"[pretrained] {tok['examples_checked']} examples built through the "
        f"C++ tokenizer equal the Python route's, and {len(NON_ASCII)} "
        f"non-ASCII texts take the Python route with the same ids; encoder "
        f"inputs of ~{tok['words_per_input']:.0f} words, tokenized per "
        f"micro-batch of {B}: C++ {tok['native_ms']:.1f} ms, Python "
        f"{tok['python_cold_ms']:.1f} ms (word cache cold) / "
        f"{tok['python_warm_ms']:.1f} ms (warm); "
        f"{tok['python_route_share']:.1%} of the inputs take the Python "
        f"route")
    chem = check_native_chem(data)
    log(f"[pretrained] {chem['reactions']} reactions and "
        f"{chem['molecules']} molecules: C++ fingerprints and canonical "
        f"SMILES equal the Python route's; reaction fingerprints "
        f"{chem['native_fps_per_s']:.0f}/s C++, "
        f"{chem['python_fps_per_s']:.0f}/s Python; on {card}")
    results["pretrained"] = dict(
        import_ms=checked["import_ms"], checkpoint_gb=size_gb,
        step_ms=step_ms, bare_step_ms=bare_step_ms,
        tokenize_native_ms=tok["native_ms"],
        tokenize_python_cold_ms=tok["python_cold_ms"],
        tokenize_python_warm_ms=tok["python_warm_ms"],
        python_route_share=tok["python_route_share"],
        fingerprints_native_per_s=chem["native_fps_per_s"],
        fingerprints_python_per_s=chem["python_fps_per_s"])


def write_template_fixture(root: Path, seed: int = 0) -> None:
    """The template tables (TEMPLATE_CLASSES; bond class 1 the ester
    hydrolysis, with its template_infos.csv row), a split each of
    TEMPLATE_SIZES reactions over DRUGS and ESTERS with template labels
    drawn from `seed` (an ester is labelled at its ester bond with class 1,
    any other product with a random atom and a random bond class), the
    preprocessed label files, a corpus row a training reaction and
    neighbour files of five training ids each."""
    import random
    rng = random.Random(seed)
    root.mkdir(parents=True)

    def write(name, header, rows):
        with open(root / name, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            w.writerows(rows)

    n_atom, n_bond = TEMPLATE_CLASSES["atom"], TEMPLATE_CLASSES["bond"]
    write("atom_templates.csv", ["Template", "Frequency", "Class"],
          [[f"[T{i}]>>[U{i}]", 1000 - i, i + 1] for i in range(n_atom)])
    write("bond_templates.csv", ["Template", "Frequency", "Class"],
          [[ESTER_TEMPLATE, 500, 1]]
          + [[f"[B{i}]>>[V{i}]", 500 - i, i + 1] for i in range(1, n_bond)])
    write("template_infos.csv",
          ["Template", "edit_site", "change_H", "change_C", "change_S"],
          [[ESTER_TEMPLATE] + [repr(ESTER_INFO[k]) for k in
                               ("edit_site", "change_H", "change_C",
                                "change_S")]])
    ester_site = parse_smarts(ESTER_TEMPLATE.split(">>")[0])
    products = DRUGS + list(ESTERS)
    train_ids = [f"train_{i}" for i in range(TEMPLATE_SIZES["train"])]
    for split, n in TEMPLATE_SIZES.items():
        rows, pre, nn = [], [], []
        for i in range(n):
            prod = products[(i + rng.randrange(3)) % len(products)]
            mol = parse_smiles(prod)
            bonds = sorted({p for b in mol.bonds
                            for p in ((b.a1, b.a2), (b.a2, b.a1))})
            if prod in ESTERS:
                match = find_matches(ester_site, mol)[0]
                labels = [("b", (match[0], match[2]), 1)]
            else:
                labels = [("a", rng.randrange(len(mol.atoms)),
                           rng.randrange(1, n_atom + 1)),
                          ("b", rng.choice(bonds),
                           rng.randrange(2, n_bond + 1))]
            rows.append([f"{split}_{i}", prod, ESTERS.get(prod, prod + ".O")])
            pre.append([repr(labels), repr(list(range(len(mol.atoms)))),
                        repr(set(bonds))])
            nn.append({"id": f"{split}_{i}", "nn": rng.sample(train_ids, 5)})
        write(f"{split}.csv", ["id", "product_smiles", "reactant_smiles"],
              rows)
        write(f"preprocessed_{split}.csv",
              ["Labels", "ProductAtomIdx2CanonIdx", "ProductCanonBonds"],
              pre)
        (root / f"{split}_nn.json").write_text(json.dumps(nn))
    write_corpus(root / "corpus.csv", train_ids, seed)


def template_config(data: Path, vocab: Path, **kw) -> ExperimentConfig:
    """scripts/parity_run.py's RetroSyn_tb: SciBERT-base encoder over the
    joint SMILES + text vocabulary, --unattend_nonbonds, 3 neighbours with
    the gold one, L=512, lr 2e-4, warmup 0.02, global batch 128 (4 x 32),
    bf16 compute; clip 5, AdamW, cosine (the defaults); no MLM."""
    cfg = ExperimentConfig(
        task="retro", template_based=True, unattend_nonbonds=True,
        encoder="scibert_base", encoder_tokenizer="smiles_text",
        text_vocab_file=str(vocab), data_path=str(data),
        template_path=str(data), train_file="train.csv",
        valid_file="val.csv", test_file="test.csv",
        corpus_file=str(data / "corpus.csv"), nn_path=str(data),
        train_nn_file="train_nn.json", valid_nn_file="val_nn.json",
        test_nn_file="test_nn.json", num_neighbors=3,
        use_gold_neighbor=True, max_length=L, batch_size=B * MICRO_BATCHES,
        test_batch_size=B, lr=2e-4, warmup_ratio=0.02, num_beams=20,
        compute_dtype="bfloat16", attention_impl="flash",
        layernorm_impl="fused")
    return dataclasses.replace(cfg, **kw)


def device_span_ms(fn, reps: int = 2) -> float:
    """Median device ms of `reps` calls of `fn`, each after a synchronize,
    from a CUDA event recorded on the stream before the call to one after
    it, after a warm-up call: the card's span from its first operation of
    the call to its last, idle gaps (the host issuing) included."""
    fn()
    spans = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
    return statistics.median(spans)


def device_busy_ms(fn, expect: dict, tries: int = 4,
                   need: int = 3) -> tuple:
    """(ms in which the card ran at least one kernel or copy during one call
    of `fn`, kernels and copies seen), from torch.profiler after a warm-up
    call: the median over the first `need` traces, of at most `tries`, that
    saw exactly `expect` ({fragment of a kernel's name: its launches a
    call}); without `need` such traces both read None: not measured. The
    profiler has lost launches here, a whole 23 ms kernel among them, and
    its count of the other kernels and copies of one call varies by a few
    between traces (13,248-13,254 of an uncaptured train step on an H100),
    so the traces need not agree in it: the median keeps one trace that
    lost a long kernel out of the result."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen, good = [], []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(0.1)
            fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        counts = {fragment: sum(fragment in name for name, _, _ in events)
                  for fragment in expect}
        seen.append((len(events), counts))
        if counts != expect:
            continue
        busy, reach = 0.0, None
        for start, end in sorted((start, end) for _, start, end in events):
            if reach is None or start > reach:
                busy += end - start
                reach = end
            elif end > reach:
                busy += end - reach
                reach = end
        good.append((busy / 1e3, len(events)))
        if len(good) == need:
            log(f"  profiler: busy ms {[round(b, 2) for b, _ in good]} in "
                f"traces of {[n for _, n in good]} kernels and copies; the "
                f"median taken")
            return (statistics.median(b for b, _ in good),
                    int(statistics.median(n for _, n in good)))
    log(f"  profiler: traces saw (kernels and copies, named launches) {seen},"
        f" expected {expect} in {need}: not measured")
    return None, None


def plain_bond_masked_attention(q, k, v, bias, p, gen):
    """The plain path of models/layers.py::MultiHeadAttention that a bond
    mask sends every self-attention down (layers.py:201-203 of the JAX
    package): f32 scores + bias, softmax, dropout, bf16 weights against v."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(
        q.shape[-1])
    probs = dropout(torch.softmax(s + bias, dim=-1), p, gen)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(),
                        v.float()).to(q.dtype)


def time_bond_masked_attention(card: str, mask3d: torch.Tensor) -> dict:
    """One layer's self-attention at B=32 L=512 H=12 D=64, bf16, p=0.1,
    forward and forward + backward (device ms, CUDA events): the plain path
    under the micro-batch's bond mask as a bias, the fused kernel under its
    key mask (the mask's diagonal) and F.scaled_dot_product_attention under
    the same bias in bf16 (timed only, used nowhere in the port)."""
    dev = mask3d.device
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (torch.randn(B, L, HEADS, HEAD_DIM, generator=g,
                               device=dev).to(torch.bfloat16)
                   for _ in range(4))
    bias = mask_to_bias(mask3d)
    key_mask = torch.diagonal(mask3d, dim1=1, dim2=2).contiguous()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    scale = 1.0 / math.sqrt(HEAD_DIM)
    paths = {
        "plain": lambda *a: plain_bond_masked_attention(*a, bias, DROPOUT_P,
                                                        g),
        "fused": lambda *a: fused_attention.fused_dropout_attention(
            *a, key_mask, DROPOUT_P, g, scale),
        "sdpa": lambda *a: sdpa(*a, bias.to(torch.bfloat16), DROPOUT_P)}
    out = {}
    for name, fn in paths.items():
        with torch.no_grad():
            fwd = time_ms(lambda: fn(q, k, v), reps=10)
        both = time_ms(lambda: torch.autograd.grad(fn(*leaves), leaves, do),
                       reps=10)
        out[name] = {"fwd_ms": fwd, "fwd_bwd_ms": both}
    log(f"[template] one layer's self-attention, B={B} L={L} H={HEADS} "
        f"D={HEAD_DIM}, bf16, p={DROPOUT_P}, device ms (CUDA events, median "
        f"of 10), forward / forward + backward: plain under the bond mask "
        f"{out['plain']['fwd_ms']:.4f} / {out['plain']['fwd_bwd_ms']:.4f}; "
        f"fused kernel under the key mask {out['fused']['fwd_ms']:.4f} / "
        f"{out['fused']['fwd_bwd_ms']:.4f}; SDPA under the bond mask "
        f"{out['sdpa']['fwd_ms']:.4f} / {out['sdpa']['fwd_bwd_ms']:.4f}; "
        f"on {card}")
    return out


def check_edit_ranking(module, batch: dict) -> int:
    """device_topk_edits on the card against rank_edits on the host, on the
    same probabilities, exactly: the model's own, and the same rounded to
    sixty-fourths so that values tie. Returns the edits compared."""
    with torch.no_grad():
        atom_logits, bond_logits = module(
            input_ids=batch["input_ids"],
            attention_mask=batch["attention_mask"],
            atom_indices=batch["atom_indices"],
            bond_pairs=batch["bond_pairs"])["logits"]
    a_labels = batch["atom_template_labels"]
    b_labels = batch["bond_template_labels"]
    probs = (losses.masked_probs(atom_logits, a_labels),
             losses.masked_probs(bond_logits, b_labels))
    n_a1, n_b1 = atom_logits.shape[-1], bond_logits.shape[-1]
    compared = 0
    for tag, (pa, pb) in (("model", probs),
                          ("tied", tuple((x * 64).round() / 64
                                         for x in probs))):
        top = [t.cpu().numpy() for t in device_topk_edits(
            pa, pb, b_labels != losses.IGNORE_INDEX, TEMPLATE_EDITS)]
        pa, pb = pa.cpu().numpy(), pb.cpu().numpy()
        pairs = batch["bond_pairs"].cpu().numpy()
        n_bonds = batch["bond_mask"].sum(1).cpu().numpy()
        ties = 0
        for b in range(pa.shape[0]):
            bonds = [tuple(x) for x in pairs[b, :n_bonds[b]]]
            got = edits_from_topk(*(t[b] for t in top), n_a1, n_b1, bonds,
                                  top_num=TEMPLATE_EDITS)
            want = rank_edits(pa[b], pb[b], bonds, top_num=TEMPLATE_EDITS)
            if got != want:
                raise AssertionError(f"edit ranking, {tag} probabilities, "
                                     f"example {b}: the card's top "
                                     f"{TEMPLATE_EDITS} differ from the "
                                     f"host's")
            compared += len(got[0])
            ties += sum(x == y for x, y in zip(got[1], got[1][1:]))
        log(f"[template] edit ranking, {tag} probabilities: the card's top "
            f"{TEMPLATE_EDITS} of every example equal the host's rank_edits "
            f"(ties among neighbours: {ties})")
    return compared


def check_ester_decode(data: Path, cfg, enc_tok, tables, eval_step) -> dict:
    """The ester products of the test split through the own template
    engine, three ways: (1) the gold edit alone decodes to the gold
    reactants; (2) the model's own top TEMPLATE_EDITS edits, from the eval
    step on the card: where the gold edit is among them, the gold reactants
    are within the decode's top DECODE_K; (3) the same list with the gold
    edit moved to rank PLANT_RANK (scored as its neighbour above): the
    decode walks the model's edits before it and still finds the gold
    within its top DECODE_K. The other products' gold edits, placeholder
    templates, decode to nothing."""
    table = read_csv(str(data / "test.csv"))
    labels = read_csv(str(data / "preprocessed_test.csv"))["Labels"]
    gold_edits = [tuple(ast.literal_eval(lab)[0]) for lab in labels]
    esters = [i for i, prod in enumerate(table["product_smiles"])
              if prod in ESTERS]
    if not esters:
        raise AssertionError("the test split holds no ester")
    golds = {i: canonical_smiles(table["reactant_smiles"][i])
             for i in esters}

    # the model's own ranking of the test split, as the trainer's _predict
    ds = RetrosynthesisDataset(cfg, str(data / "test.csv"), enc_tok, tables,
                               split="test")
    ds.load_corpus(read_corpus(cfg.corpus_file), str(data / "test_nn.json"))
    examples = [ds.example(i) for i in range(len(ds))]
    batch = Collator(cfg, enc_tok.pad_token_id, 0)(examples,
                                                    fixed_enc_len=L)
    res = eval_step(batch.arrays)
    top = [res[k].cpu().numpy() for k in ("atom_topk_vals", "atom_topk_idx",
                                           "bond_topk_vals", "bond_topk_idx")]
    n_a1, n_b1 = tables.num_atom_templates + 1, tables.num_bond_templates + 1
    model = {}
    for i in esters:
        model[i] = edits_from_topk(*(t[i] for t in top), n_a1, n_b1,
                                   batch.host["bonds"][i],
                                   top_num=TEMPLATE_EDITS)
        if len(model[i][0]) != TEMPLATE_EDITS:
            raise AssertionError(f"test product {i}: {len(model[i][0])} "
                                 f"ranked edits")

    def planted(i):
        edits, scores = ([e for e in model[i][0] if e != gold_edits[i]],
                         [x for e, x in zip(*model[i]) if e != gold_edits[i]])
        at = PLANT_RANK - 1
        return (edits[:at] + [gold_edits[i]] + edits[at:],
                scores[:at] + [scores[at - 1]] + scores[at:])

    def decode(ranked, top_k):
        prediction = {i: {"prediction": [], "score": []}
                      for i in range(len(table))}
        for i, (edits, scores) in ranked.items():
            prediction[i] = {"prediction": edits, "score": scores}
        t0 = time.perf_counter()
        out = decode_template_predictions(prediction, table, str(data),
                                          top_k)
        return out, time.perf_counter() - t0

    gold_only, _ = decode({i: ([e], [1.0]) for i, e in enumerate(gold_edits)},
                          1)
    own, own_s = decode(model, DECODE_K)
    plant, plant_s = decode({i: planted(i) for i in esters}, DECODE_K)
    found = [i for i in esters if gold_edits[i] in model[i][0]]
    for i in esters:
        prod = table["product_smiles"][i]
        if gold_only[i] != [golds[i]]:
            raise AssertionError(f"ester decode of {prod}: {gold_only[i]}, "
                                 f"gold {golds[i]}")
        if i in found and golds[i] not in own[i]:
            raise AssertionError(f"{prod}: the gold edit is at rank "
                                 f"{model[i][0].index(gold_edits[i]) + 1} of "
                                 f"the model's, its decode {own[i]} lacks "
                                 f"the gold {golds[i]}")
        if golds[i] not in plant[i]:
            raise AssertionError(f"{prod}: the model's edits with the gold "
                                 f"at rank {PLANT_RANK} decode to "
                                 f"{plant[i]}, gold {golds[i]}")
    if any(gold_only[i] for i in range(len(table)) if i not in esters):
        raise AssertionError("placeholder templates decoded to reactants")
    log(f"[template] ester decode through the own engine, {len(esters)} of "
        f"{len(table)} test products: the gold edit alone gives the gold "
        f"reactants (e.g. {golds[esters[0]]}); the model's top "
        f"{TEMPLATE_EDITS} edits hold the gold edit for {len(found)} of them "
        f"and decode to {sum(map(len, (own[i] for i in esters)))} reactant "
        f"sets in {own_s:.2f} s; with the gold edit at rank {PLANT_RANK} "
        f"every ester's top {DECODE_K} holds the gold (at positions "
        f"{[plant[i].index(golds[i]) + 1 for i in esters]}), {plant_s:.2f} s")
    return {"esters": len(esters), "gold_in_model_top": len(found),
            "decode_s": own_s, "planted_decode_s": plant_s}


def phase_template(card: str, tmp: Path, vocab: Path,
                   results: dict) -> None:
    """Template-based retrosynthesis at full width and depth: three
    optimizer steps under the bond mask, one without it, the edit ranking
    and the ester decode, the self-attention's cost under the bond mask,
    kernels against plain functions, then the command line."""
    data = tmp / "template_data"
    write_template_fixture(data)
    cfg = template_config(data, vocab)
    enc_tok, tables = get_tokenizers(cfg)
    t0 = time.perf_counter()
    module, enc_cfg, dec_cfg = build_model(cfg, enc_tok, tables,
                                           torch.Generator().manual_seed(0))
    if dec_cfg is not None:
        raise AssertionError("a template model has no decoder")
    log(f"[template] model built in {time.perf_counter() - t0:.1f} s: "
        f"encoder {enc_cfg.num_hidden_layers}x{enc_cfg.hidden_size} vocab "
        f"{enc_cfg.vocab_size}, heads {tables.num_atom_templates + 1} atom "
        f"and {tables.num_bond_templates + 1} bond classes, "
        f"{sum(p.numel() for p in module.parameters()) / 1e6:.1f} M params, "
        f"compute {cfg.compute_dtype}, dropout "
        f"{enc_cfg.hidden_dropout_prob}/{enc_cfg.attention_probs_dropout_prob}")

    # one global batch as the loader builds it
    ds = RetrosynthesisDataset(cfg, str(data / "train.csv"), enc_tok, tables)
    ds.load_corpus(read_corpus(cfg.corpus_file), str(data / "train_nn.json"))
    examples = [ds.example(i, example_rng(cfg.seed, 0, i))
                for i in range(cfg.batch_size)]
    collate = Collator(cfg, enc_tok.pad_token_id, 0)
    batch = collate(examples, fixed_enc_len=L)
    micro = as_microbatches(batch, MICRO_BATCHES)
    tokens = [len(ex["input_ids"]) for ex in examples]
    atoms = [len(ex["atom_indices"]) for ex in examples]
    log(f"[template] {cfg.batch_size} examples as {MICRO_BATCHES} x {B}: "
        f"tokens {min(tokens)}-{max(tokens)}, atoms {min(atoms)}-{max(atoms)}"
        f"; " + ", ".join(f"{k} {v.shape[1:]}" for k, v in micro.items()))
    # the loader's host cost of the bond masks of one micro-batch
    mb = examples[:B]
    t0 = time.perf_counter()
    masks = [ds._bond_mask(ex) for ex in mb]
    mask_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _pad_2d(masks, L, B)
    pad_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for i in range(B):
        ds.example(i, example_rng(cfg.seed, 1, i))
    example_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    collate(mb, fixed_enc_len=L)
    collate_ms = (time.perf_counter() - t0) * 1e3
    log(f"[template] loader, one micro-batch of {B} on the host: bond masks "
        f"{mask_ms:.1f} ms (int32 arrays of {L} x {L}), their copy into one "
        f"({B}, {L}, {L}) array {pad_ms:.1f} ms; whole examples (tokenize, "
        f"neighbours, labels, masks) {example_ms:.1f} ms; the collator "
        f"{collate_ms:.1f} ms")

    # three optimizer steps under the bond mask (the schedule spans them
    # and the step without the mask; the profiled steps run at lr 0)
    optimizer = make_optimizer(cfg, TRAIN_STEPS + 1, module.named_parameters())
    state = TrainState.create(module, optimizer)
    train_step = make_accum_train_step(module, cfg, optimizer, 0)
    before = [p.detach().clone() for p in module.parameters()]
    weights = np.ones(MICRO_BATCHES, np.float32)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    history, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, micro, weights, cfg.seed)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in metrics.items()})
        log(f"[template] step {state.step}: {history[-1]} "
            f"{step_ms[-1]:.1f} ms")
    counts = read_counts()
    layers = enc_cfg.num_hidden_layers
    per_step = 2 * layers * MICRO_BATCHES
    want = {name: 0 for name in counts}
    want.update(fused_layernorm_fwd=per_step * TRAIN_STEPS,
                fused_layernorm_bwd=per_step * TRAIN_STEPS)
    log(f"[template] launches over {TRAIN_STEPS} steps under the bond mask: "
        f"{counts}")
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want}")
    for name in ("fused_layernorm_fwd", "fused_layernorm_bwd",
                 "fused_attention_fwd", "fused_attention_bwd"):
        results[name]["launches_template"] = counts[name]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"non-finite metric: {history}")
    if not history[-1]["train_loss"] < history[0]["train_loss"]:
        raise AssertionError(f"the loss did not fall: {history}")
    changed = sum(int(not torch.equal(a, b))
                  for a, b in zip(before, module.parameters()))
    if changed != len(before):
        raise AssertionError(f"only {changed} of {len(before)} parameter "
                             f"tensors changed")
    del before
    uncaptured_gb = uncaptured_peak_gb(module, cfg, optimizer, 0, micro,
                                       state.step)

    # the same batch without the bond mask: the fused attention kernels
    keyed = dict(micro, attention_mask=np.ascontiguousarray(np.diagonal(
        micro["attention_mask"], axis1=2, axis2=3)))
    reset_counts()
    state, metrics = train_step(state, keyed, weights, cfg.seed)
    counts = read_counts()
    # the key's first step ran its micro-batch part once uncaptured and
    # captured it: time the step after it, a replay as the others are
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = train_step(state, keyed, weights, cfg.seed)
    torch.cuda.synchronize()
    keyed_ms = (time.perf_counter() - t0) * 1e3
    want = dict(want, fused_layernorm_fwd=per_step,
                fused_layernorm_bwd=per_step,
                fused_attention_fwd=layers * MICRO_BATCHES,
                fused_attention_bwd=layers * MICRO_BATCHES)
    if counts != want or not np.isfinite(float(metrics["train_loss"])):
        raise AssertionError(f"the step without the bond mask: launches "
                             f"{counts}, expected {want}; {metrics}")
    for name in ("fused_attention_fwd", "fused_attention_bwd"):
        results[name]["launches_template_no_mask"] = counts[name]
    # the card's span of a step (CUDA events) and its busy time (a profiler
    # trace that saw every launch of the kernels the step is known to make)
    ln = {"residual_layernorm_fwd": per_step, "residual_layernorm_bwd":
          per_step}
    attn = {"attention_fwd": layers * MICRO_BATCHES,
            "attention_bwd_dq": layers * MICRO_BATCHES,
            "attention_bwd_dkv": layers * MICRO_BATCHES}
    step_span = device_span_ms(lambda: train_step(state, micro, weights,
                                                  cfg.seed))
    keyed_span = device_span_ms(lambda: train_step(state, keyed, weights,
                                                   cfg.seed))
    step_busy, step_kernels = device_busy_ms(
        lambda: train_step(state, micro, weights, cfg.seed),
        dict(ln, **dict.fromkeys(attn, 0)))
    keyed_busy, keyed_kernels = device_busy_ms(
        lambda: train_step(state, keyed, weights, cfg.seed), dict(ln, **attn))
    med = statistics.median(step_ms[1:])
    log(f"[template] {med:.1f} ms per optimizer step under the bond mask "
        f"(host clock, median of steps 2-{TRAIN_STEPS}; step 1 "
        f"{step_ms[0]:.1f} ms), the card's span {step_span:.1f} ms (CUDA "
        f"events, median of 2), busy {fmt_ms(step_busy, 1)} of a profiled "
        f"step ({step_kernels} kernels and copies), peak device memory "
        f"{peak_gb:.1f} GB ({train_step.route}; one uncaptured step "
        f"{uncaptured_gb:.1f} GB); without the bond mask {keyed_ms:.1f} ms, span "
        f"{keyed_span:.1f} ms, busy {fmt_ms(keyed_busy, 1)} "
        f"({keyed_kernels}); launches of that step {counts}; "
        f"{cfg.batch_size} examples at L={L}, on {card}")

    # the eval step at the test pass's edit_topk on its two routes under
    # the bond mask, the four micro-batches in turn; the ranking, the
    # decode on the graphed route
    batches = [{k: v[i] for k, v in micro.items()}
               for i in range(MICRO_BATCHES)]
    eval_step, results["eval"]["template"] = eval_routes(
        card, "template", module, cfg, 0, batches,
        {"fused_layernorm_fwd": 2 * layers}, results,
        edit_topk=TEMPLATE_EDITS)
    first = batches[0]
    res = eval_step(first)
    if res["loss"].shape != (B,) or not bool(torch.isfinite(
            res["loss"]).all()) or res["atom_topk_idx"].shape != (
            B, TEMPLATE_EDITS):
        raise AssertionError(f"eval step: {res['loss'].shape} "
                             f"{res['atom_topk_idx'].shape}")
    eval_ms = results["eval"]["template"]["cuda_graphs"]["host_ms"]
    compared = check_edit_ranking(module, to_device(first,
                                                    torch.device("cuda")))
    log(f"[template] eval step, top {TEMPLATE_EDITS} edits on the card: "
        f"{eval_ms:.1f} ms a micro-batch of {B} (host clock), mean loss "
        f"{float(res['loss'].mean()):.4f}; {compared} ranked edits compared")
    decode = check_ester_decode(data, cfg, enc_tok, tables, eval_step)
    decode["eval_keys"] = eval_labels(eval_step)

    # what the bond mask costs one layer's attention
    attention = time_bond_masked_attention(card, to_device(
        {"m": micro["attention_mask"][0]}, torch.device("cuda"))["m"])
    plain_ms = layers * MICRO_BATCHES * attention["plain"]["fwd_bwd_ms"]
    attention["step_plain_ms"] = plain_ms
    attention["share_of_span"] = plain_ms / step_span
    attention["share_of_busy"] = (None if step_busy is None
                                  else plain_ms / step_busy)
    log(f"[template] {layers * MICRO_BATCHES} passes of the plain bond-masked"
        f" attention (forward + backward) take {plain_ms:.1f} ms: "
        f"{attention['share_of_span'] * 100:.1f}% of the step's span on the "
        f"card, " + ("busy time not measured" if step_busy is None else
                     f"{attention['share_of_busy'] * 100:.1f}% of its busy "
                     f"time") + f"; on {card}")
    del module, optimizer, state, train_step, eval_step
    torch.cuda.empty_cache()

    # kernels against plain functions, with and without the bond mask
    phase_train_kernels_vs_plain(cfg, enc_tok, tables, micro, 0,
                                 tag="template, bond mask")
    phase_train_kernels_vs_plain(cfg, enc_tok, tables, keyed, 0,
                                 tag="template, key mask")
    torch.cuda.empty_cache()

    # the command line
    cli = phase_template_cli(card, data, vocab, tmp / "template_run", layers)
    del cli["launches"]
    results["template"] = dict(
        step_ms=med, step_span_ms=step_span, step_busy_ms=step_busy,
        step_kernels=step_kernels, no_mask_step_ms=keyed_ms,
        no_mask_span_ms=keyed_span, no_mask_busy_ms=keyed_busy,
        peak_gb=peak_gb, uncaptured_peak_gb=uncaptured_gb,
        bond_mask_ms=mask_ms, bond_mask_copy_ms=pad_ms,
        examples_ms=example_ms, collate_ms=collate_ms, eval_ms=eval_ms,
        attention=attention, decode=decode, **cli)


def template_cli_argv(data: Path, vocab: Path, save: Path) -> list:
    """The RetroSyn_tb recipe's command line on the phase's CSVs: one epoch,
    --do_train --do_valid --do_test."""
    return [
        "--task", "retro", "--template_based", "--unattend_nonbonds",
        "--do_train", "--do_valid", "--do_test", "--data_path", str(data),
        "--template_path", str(data), "--train_file", "train.csv",
        "--valid_file", "val.csv", "--test_file", "test.csv",
        "--corpus_file", str(data / "corpus.csv"), "--nn_path", str(data),
        "--train_nn_file", "train_nn.json", "--valid_nn_file", "val_nn.json",
        "--test_nn_file", "test_nn.json", "--encoder", "scibert_base",
        "--encoder_tokenizer", "smiles_text", "--text_vocab_file",
        str(vocab), "--num_neighbors", "3", "--use_gold_neighbor",
        "--max_length", str(L), "--batch_size", str(B),
        "--gradient_accumulation_steps", str(MICRO_BATCHES),
        "--test_batch_size", str(B), "--epochs", "1", "--lr", "2e-4",
        "--warmup", "0.02", "--max_grad_norm", "5", "--num_beams", "20",
        "--compute_dtype", "bfloat16", "--save_path", str(save),
        "--log_every", "1", "--debug"]


def template_cli_launches(layers: int, sizes: dict) -> dict:
    """The launches of one template-based command-line run on `sizes`
    reactions with `layers` encoder layers: an epoch of training, fit's and
    --do_valid's validation, a test pass on each of the two corpora. Only
    the residual LN runs on the card (no decoder, and attention under the
    bond mask takes the plain path); every other count is 0."""
    mbs = -(-sizes["train"] // B)
    evals = 2 * 2 * -(-sizes["val"] // B)  # fit's and --do_valid's
    tests = 2 * -(-sizes["test"] // B)     # two corpora each
    return dict(fused_layernorm_fwd=2 * layers * (mbs + evals + tests),
                fused_layernorm_bwd=2 * layers * mbs)


def check_launches(what: str, counts: dict, launches: dict) -> None:
    """`counts` (read_counts) are `launches` and 0 for every other kernel."""
    want = dict.fromkeys(counts, 0)
    want.update(launches)
    if counts != want:
        raise AssertionError(f"{what} launched {counts}, expected {want}")


def phase_template_cli(card: str, data: Path, vocab: Path, save: Path,
                       layers: int, sizes: dict = TEMPLATE_SIZES) -> dict:
    """python -m textreact_tpu_torch --task retro --template_based
    --unattend_nonbonds, in-process on the card: one epoch of `sizes`
    reactions on the CSVs in `data`, validate, test with the decode."""
    reset_counts()
    t0 = time.perf_counter()
    routes: list = []
    with trainer_routes(routes):
        accuracies = runtime_cli.main(template_cli_argv(data, vocab, save))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    check_launches("the command line", counts,
                   template_cli_launches(layers, sizes))
    return dict(check_template_run(card, save, sizes, accuracies, seconds,
                                   counts),
                route=check_trainer_route("template", routes))


def check_template_run(card: str, save: Path, sizes: dict, accuracies,
                       seconds: float, counts: dict) -> dict:
    """What a template-based run on `sizes` reactions left in `save` (its
    metrics, its decoded predictions) and returned (`accuracies`), checked
    and logged; its timings and launch `counts`."""
    accum = MICRO_BATCHES
    records = read_metrics(save)
    timing = [r for r in records if "epoch_seconds" in r][0]
    mbs = -(-sizes["train"] // B)
    # the atoms are padded to a batch's largest product, and each shape
    # group accumulates apart: one that ends the epoch with a partial
    # window takes one more, unlogged step (its weight-0 fill runs nothing)
    windows = accum * int(timing["epoch_steps"])
    losses_seen = [r["train_loss"] for r in records if "train_loss" in r]
    val = [r for r in records if "val_acc" in r]
    if not accum * len(losses_seen) <= mbs <= windows or (
            windows == mbs and accum * len(losses_seen) != mbs) or not all(
            np.isfinite(v) for v in losses_seen):
        raise AssertionError(f"train_loss records: {losses_seen} for {mbs} "
                             f"micro-batches in {windows // accum} steps")
    if len(val) != 1 or "val_acc/1" not in val[0]:
        raise AssertionError(f"validation records: {val}")
    for li in (0, 1):
        preds = json.loads((save / f"prediction_test_{li}.json").read_text())
        if sorted(map(int, preds)) != list(range(sizes["test"])):
            raise AssertionError(f"prediction_test_{li}.json: {len(preds)}")
        for p in preds.values():
            scores = p["score"]
            if not (0 < len(p["prediction"]) == len(scores) <= TEMPLATE_EDITS
                    and all(a >= b for a, b in zip(scores, scores[1:]))):
                raise AssertionError(f"prediction_test_{li}.json: {p}")
    if len(accuracies) != 2 or any(
            set(a) != {1, 2, 3, 5, 10, 20}
            or not all(0.0 <= v <= 1.0 for v in a.values())
            for a in accuracies):
        raise AssertionError(f"retro top-k dicts: {accuracies}")
    tests_s = sum(r["test_seconds"] for r in records if "test_seconds" in r)
    validation = check_eval_records("template", records,
                                    2 * -(-sizes["val"] // B))
    # each test pass makes its own eval step: its keys and replays
    test_batches = -(-sizes["test"] // B)
    passes = [r for r in records if "test_seconds" in r]
    if len(passes) != 2 or any(
            r["eval_route"] != "cuda_graphs"
            or r["eval_keys"] + r["eval_replays"] != test_batches
            for r in passes):
        raise AssertionError(f"test pass records: {passes}")
    validation["test_keys"] = [int(r["eval_keys"]) for r in passes]
    validation["test_replays"] = [int(r["eval_replays"]) for r in passes]
    log(f"[template] command line's test passes on the eval step's graphed "
        f"route: keys captured {validation['test_keys']} and replays "
        f"{validation['test_replays']} of {test_batches} batches a pass")
    log(f"[template] command line: train {sizes['train']} "
        f"reactions ({timing['epoch_steps']:.0f} optimizer steps of {accum} x "
        f"{B}, "
        f"train_loss {losses_seen}), validate, test and decode "
        f"{sizes['test']} x 2 corpora in {seconds:.1f} s: epoch "
        f"{timing['epoch_seconds']:.1f} s, test passes {tests_s:.1f} s "
        f"(top {TEMPLATE_EDITS} edits on the card), val_acc "
        f"{val[0]['val_acc']:.3f} / {val[0]['val_acc/1']:.3f}, retro top-k "
        f"{accuracies[0]} / {accuracies[1]}; launches {counts}; on {card}")
    return dict(cli_seconds=seconds, cli_epoch_seconds=timing["epoch_seconds"],
                cli_step_ms=timing["epoch_seconds"] / timing["epoch_steps"]
                * 1e3, cli_test_seconds=tests_s, launches=counts,
                cli_eval=validation)


# --- 12b. template-free retrosynthesis --------------------------------------

# the f32 cache check: a beam's score (its log-probabilities added one step
# at a time in f32) against the same tokens' log-probabilities from the
# teacher-forced decoder, summed in f64. A log-probability is log-softmax of
# f32 logits that the two sides compute in other orders (one row a step over
# the cache against the whole sequence at once; in the encoder the kernels
# against the plain functions, 7e-6 apart in its states, PERF.md): logits a
# few ulps of their size apart, ~1e-6 here, and log-softmax moves by at most
# twice the largest logit difference. RESCORE_TOKEN_BOUND allows 50 times
# that a token. The beam's running sum rounds once a step, by at most half
# an ulp of the sum: 2^-24 |score| a token. A row attending over another
# beam's history moves its log-probabilities by orders of magnitude more
RESCORE_TOKEN_BOUND = 1e-4
# host retro scoring: examples of RETRO_BEAMS beams, the gold planted at
# this rank (1-based), as the trainer scores a test pass
SCORING_EXAMPLES, SCORING_RANK = 5000, 3


def retro_config(data: Path, vocab: Path, **kw) -> ExperimentConfig:
    """scripts/torch_port/train_RetroSyn_tf.sh on the CSVs in `data`:
    SciBERT-base encoder over the text tokenizer (the recipe sets none),
    bert_l6 decoder over the SMILES vocabulary at 160 positions, 3
    neighbours with the gold one and a random share of 0.2, MLM (mlp,
    ratio 0.15, lambda 0.1), lr 1e-4, warmup 0.02, global batch 128 (4 x
    32), test batches of 32, beam 20, bf16 compute; clip 5, AdamW, cosine
    (the defaults); and parity_run.py's --shuffle_smiles, which the
    script leaves out, so that the loader's random SMILES run too."""
    cfg = ExperimentConfig(
        task="retro", encoder="scibert_base", decoder="bert_l6",
        text_vocab_file=str(vocab), data_path=str(data),
        train_file="train.csv", valid_file="val.csv", test_file="test.csv",
        corpus_file=str(data / "corpus.csv"), nn_path=str(data),
        train_nn_file="train_nn.json", valid_nn_file="val_nn.json",
        test_nn_file="test_nn.json", num_neighbors=3,
        use_gold_neighbor=True, random_neighbor_ratio=0.2, max_length=L,
        max_dec_length=RETRO_DEC_LEN, shuffle_smiles=True, mlm=True,
        mlm_ratio=0.15, mlm_layer="mlp", mlm_lambda=0.1, lr=1e-4,
        warmup_ratio=0.02, batch_size=B * MICRO_BATCHES, test_batch_size=B,
        num_beams=RETRO_BEAMS, compute_dtype="bfloat16",
        attention_impl="flash", layernorm_impl="fused")
    return dataclasses.replace(cfg, **kw)


def retro_batch(cfg, enc_tok, dec_tok, split: str, n: int):
    """n examples of `split` as the loader builds them (a training split
    augmented: shuffled product SMILES, span MLM), collated at L and, with
    decoder inputs, at 160 decoder positions."""
    data = Path(cfg.data_path)
    ds = RetrosynthesisDataset(cfg, str(data / f"{split}.csv"), enc_tok,
                               dec_tok, split=split)
    ds.load_corpus(read_corpus(cfg.corpus_file),
                   str(data / f"{split}_nn.json"))
    examples = [ds.example(i % len(ds), example_rng(cfg.seed, 0, i))
                for i in range(n)]
    collate = Collator(cfg, enc_tok.pad_token_id, dec_tok.pad_token_id)
    return collate(examples, fixed_enc_len=L, fixed_dec_len=RETRO_DEC_LEN)


@torch.inference_mode()
def teacher_forced_scores(module, batch: dict, seqs: np.ndarray, steps: int,
                          eos_id: int, examples_a_chunk: int = 8):
    """(scores (B, K) in f64, tokens scored (B, K)): each sequence's
    log-probability by the teacher-forced decoder
    (`EncoderDecoder.decode_logits` over BOS and the generated tokens,
    log-softmax in f32), summed over the tokens that beam search scored:
    positions 1 up to the first EOS, or up to `steps` without one."""
    dev = module.decoder.word_embedding.device
    ids = torch.as_tensor(np.asarray(batch["input_ids"]), dtype=torch.long,
                          device=dev)
    mask = torch.as_tensor(np.asarray(batch["attention_mask"]),
                           dtype=torch.int32, device=dev)
    tokens = torch.as_tensor(seqs, dtype=torch.long, device=dev)
    n_ex, beams, length = tokens.shape
    pos = torch.arange(length, device=dev)
    first_eos = torch.where(tokens == eos_id, pos, length).amin(-1)
    last = torch.clamp(first_eos, max=steps)
    scored = (pos >= 1) & (pos <= last[..., None])          # (B, K, T)
    enc = module.encode(ids, mask)
    out = torch.zeros(n_ex, beams, dtype=torch.float64, device=dev)
    for b0 in range(0, n_ex, examples_a_chunk):
        b1 = min(n_ex, b0 + examples_a_chunk)
        rows = tokens[b0:b1].reshape(-1, length)
        logits = module.decode_logits(
            rows[:, :-1], enc[b0:b1].repeat_interleave(beams, 0),
            mask[b0:b1].repeat_interleave(beams, 0))
        logp = torch.log_softmax(logits.float(), dim=-1)
        picked = logp.gather(-1, rows[:, 1:, None])[..., 0].double()
        keep = scored[b0:b1].reshape(-1, length)[:, 1:]
        out[b0:b1] = torch.where(keep, picked, 0.0).sum(-1).view(b1 - b0,
                                                                 beams)
    return out.cpu().numpy(), scored.sum(-1).cpu().numpy()


def rescore_tolerance(n_tokens: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """RESCORE_TOKEN_BOUND and the beam's f32 running sum, a token each."""
    return n_tokens * (RESCORE_TOKEN_BOUND + 2.0 ** -24 * np.abs(scores))


def check_beams(what: str, seqs: np.ndarray, scores: np.ndarray,
                steps: int) -> None:
    """Shapes (B, 20, 160) and (B, 20), finite scores that do not increase
    across beams, and 1 to 159 decode steps (159: no early stop, the worst
    case that untrained weights gave the JAX package)."""
    if seqs.shape != (B, RETRO_BEAMS, RETRO_DEC_LEN) or scores.shape != (
            B, RETRO_BEAMS):
        raise AssertionError(f"{what}: shapes {seqs.shape} {scores.shape}")
    if not np.isfinite(scores).all() or not (np.diff(scores, axis=1)
                                             <= 0).all():
        raise AssertionError(f"{what}: scores not finite or increasing")
    if not 1 <= steps <= RETRO_DEC_LEN - 1:
        raise AssertionError(f"{what}: {steps} decode steps")


def serving_launches(enc_layers: int, dec_layers: int, replays: int) -> dict:
    """A generate call's launches: the encoder's attention and two LNs a
    layer, then three LNs and one decode attention a decoder layer each
    decode step the card ran (`Generator.last_replays`: the steps, and
    past a stop those that change nothing)."""
    return dict(fused_attention_fwd=enc_layers,
                fused_layernorm_fwd=2 * enc_layers + 3 * dec_layers * replays,
                grouped_decode_attn=dec_layers * replays)


def retro_train(card: str, cfg, enc_tok, dec_tok, results: dict):
    """Three optimizer steps of 4 x 32 at L=512 with the decoder at 160:
    finite metrics, a falling loss, changed parameters and the exact
    launches. Returns the micro-batches and the step's numbers."""
    t0 = time.perf_counter()
    module, enc_cfg, dec_cfg = build_model(cfg, enc_tok, dec_tok,
                                           torch.Generator().manual_seed(0))
    if dec_cfg.vocab_size != max(PRESETS["bert_l6"].vocab_size,
                                 len(dec_tok)) or (
            dec_cfg.max_position_embeddings < RETRO_DEC_LEN):
        raise AssertionError(f"decoder vocab {len(dec_tok)} in a table of "
                             f"{dec_cfg.vocab_size}, positions "
                             f"{dec_cfg.max_position_embeddings}")
    log(f"[retro_tf] model built in {time.perf_counter() - t0:.1f} s: "
        f"{describe(module, enc_cfg, dec_cfg)} (SMILES vocabulary "
        f"{len(dec_tok)}), {dec_cfg.max_position_embeddings} decoder "
        f"positions, compute {cfg.compute_dtype}, dropout "
        f"{enc_cfg.hidden_dropout_prob}/{enc_cfg.attention_probs_dropout_prob}")
    batch = retro_batch(cfg, enc_tok, dec_tok, "train", cfg.batch_size)
    micro = as_microbatches(batch, MICRO_BATCHES)
    if micro["input_ids"].shape != (MICRO_BATCHES, B, L) or micro[
            "decoder_input_ids"].shape != (MICRO_BATCHES, B, RETRO_DEC_LEN):
        raise AssertionError(f"micro-batches {micro['input_ids'].shape} "
                             f"{micro['decoder_input_ids'].shape}")
    dec_tokens = batch.arrays["decoder_attention_mask"].sum(1)
    log(f"[retro_tf] {cfg.batch_size} examples as {MICRO_BATCHES} x {B}: "
        f"encoder tokens {int(batch.arrays['attention_mask'].sum(1).min())}"
        f"-{int(batch.arrays['attention_mask'].sum(1).max())}, decoder "
        f"tokens {int(dec_tokens.min())}-{int(dec_tokens.max())}; "
        + ", ".join(f"{k} {v.shape[1:]}" for k, v in micro.items()))
    optimizer = make_optimizer(cfg, TRAIN_STEPS, module.named_parameters())
    state = TrainState.create(module, optimizer)
    train_step = make_accum_train_step(module, cfg, optimizer,
                                       dec_tok.pad_token_id)
    before = [p.detach().clone() for p in module.parameters()]
    weights = np.ones(MICRO_BATCHES, np.float32)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    history, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, micro, weights, cfg.seed)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in metrics.items()})
        log(f"[retro_tf] step {state.step}: {history[-1]} "
            f"{step_ms[-1]:.1f} ms")
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    enc_layers, dec_layers = (enc_cfg.num_hidden_layers,
                              dec_cfg.num_hidden_layers)
    # a micro-batch: attention in the encoder only (the decoder carries a
    # bias), two LNs an encoder layer at B * L = 16384 rows and three a
    # decoder layer at B * 160 = 5120 rows
    per_step = {"fused_attention_fwd": enc_layers * MICRO_BATCHES,
                "fused_attention_bwd": enc_layers * MICRO_BATCHES,
                "fused_layernorm_fwd": (2 * enc_layers + 3 * dec_layers)
                * MICRO_BATCHES,
                "fused_layernorm_bwd": (2 * enc_layers + 3 * dec_layers)
                * MICRO_BATCHES}
    check_launches(f"{TRAIN_STEPS} RetroSyn_tf steps", counts,
                   {k: v * TRAIN_STEPS for k, v in per_step.items()})
    for name, n in per_step.items():
        results[name]["launches_retro_tf_step"] = n
    if not all(np.isfinite(v) for h in history for v in h.values()) or not \
            all(h["grad_norm"] > 0.0 for h in history):
        raise AssertionError(f"non-finite metric or zero norm: {history}")
    if not history[-1]["train_loss"] < history[0]["train_loss"]:
        raise AssertionError(f"the loss did not fall: {history}")
    changed = sum(int(not torch.equal(a, b))
                  for a, b in zip(before, module.parameters()))
    if changed != len(before):
        raise AssertionError(f"only {changed} of {len(before)} parameter "
                             f"tensors changed")
    uncaptured_gb = uncaptured_peak_gb(module, cfg, optimizer,
                                       dec_tok.pad_token_id, micro,
                                       state.step)
    # the eval step on its two routes with the decoder at 160, the four
    # micro-batches in turn
    _, results["eval"]["retro_tf"] = eval_routes(
        card, "retro_tf", module, cfg, dec_tok.pad_token_id,
        [{k: v[i] for k, v in micro.items()} for i in range(MICRO_BATCHES)],
        {"fused_attention_fwd": enc_layers,
         "fused_layernorm_fwd": 2 * enc_layers + 3 * dec_layers}, results)
    med = statistics.median(step_ms[1:])
    log(f"[retro_tf] {med:.1f} ms per optimizer step (host clock, median of "
        f"steps 2-{TRAIN_STEPS}; step 1 {step_ms[0]:.1f} ms) = "
        f"{cfg.batch_size / med * 1e3:.1f} examples/s for {MICRO_BATCHES} x "
        f"{B} examples at L={L}, decoder at {RETRO_DEC_LEN}, bf16 compute, "
        f"f32 parameters, dropout {DROPOUT_P}, MLM; launches a step "
        f"{per_step} (LN: {2 * enc_layers * MICRO_BATCHES} at {B * L} rows "
        f"+ {3 * dec_layers * MICRO_BATCHES} at {B * RETRO_DEC_LEN}); peak "
        f"device memory {peak_gb:.1f} GB ({train_step.route}; one uncaptured "
        f"step {uncaptured_gb:.1f} GB); on {card}")
    return micro, dict(step_ms=med, first_step_ms=step_ms[0],
                       examples_per_s=cfg.batch_size / med * 1e3,
                       peak_gb=peak_gb, uncaptured_peak_gb=uncaptured_gb,
                       losses=[h["train_loss"] for h in history],
                       launches_a_step=per_step)


def retro_serving(card: str, cfg, enc_tok, dec_tok, batch, results: dict):
    """One test batch of 32 through Generator.generate at beam 20 over 160
    positions with bf16 weights: the beams' checks, exact launches, ms a
    batch, the encoder's and a decode step's, peak memory. Returns the
    numbers and the decoded predictions."""
    module, enc_cfg, dec_cfg = build_model(
        dataclasses.replace(cfg, param_dtype="bfloat16"), enc_tok, dec_tok,
        torch.Generator().manual_seed(0))
    gen = Generator(module, num_beams=RETRO_BEAMS, max_length=RETRO_DEC_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.max_memory_allocated() / 1e9
    reset_counts()
    seqs, scores = gen.generate(batch)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps, replays = gen.last_steps, gen.last_replays
    check_beams("retro serving", seqs, scores, steps)
    want = serving_launches(enc_cfg.num_hidden_layers,
                            dec_cfg.num_hidden_layers, replays)
    check_launches("the retro serving batch", counts, want)
    for name, n in want.items():
        results[name]["launches_retro_serving"] = n
    capture = decode_graphs_report(gen)
    check_against_uncaptured("retro serving", gen, batch, (seqs, scores))
    preds = predictions_from_beams(seqs, scores, batch["indices"],
                                   batch["example_mask"], dec_tok)
    if len(preds) != B or any(len(p["prediction"]) != RETRO_BEAMS
                              for p in preds.values()):
        raise AssertionError("predictions_from_beams lost requests")
    dev = module.decoder.word_embedding.device
    ids = torch.as_tensor(batch["input_ids"], dtype=torch.long, device=dev)
    mask = torch.as_tensor(batch["attention_mask"], device=dev)
    batch_ms = wall_ms(lambda: gen.generate(batch))
    with torch.inference_mode():
        enc_ms = wall_ms(lambda: module.encode(ids, mask))
    step_ms = (batch_ms - enc_ms) / steps
    busy_ms, _ = device_busy_ms(
        lambda: gen.generate(batch),
        {"residual_layernorm_fwd": want["fused_layernorm_fwd"]})
    windows = _plan_windows(RETRO_DEC_LEN, gen.attn_windows)
    lens = batch["attention_mask"].sum(1)
    log(f"[retro_tf] serving: {batch_ms:.1f} ms a batch (host clock, median "
        f"of 5) for B={B} (encoder tokens {lens.min()}-{lens.max()}) L={L} "
        f"beam {RETRO_BEAMS} dec {RETRO_DEC_LEN}, windows {windows}, "
        f"{steps} decode steps of {B * RETRO_BEAMS} rows in {replays} "
        f"replays ({replays - steps} past the stop) of the {gen.route} "
        f"route, bf16 weights; the encoder alone (uncaptured) {enc_ms:.1f} "
        f"ms, {step_ms:.2f} ms a decode step (cache set-up included); the "
        f"card busy {fmt_ms(busy_ms, 1)} of the batch (torch.profiler), "
        f"idle {idle_share(busy_ms, batch_ms)}; capture "
        f"{capture['capture_ms']:.1f} ms in the first batch; peak device "
        f"memory {peak_gb:.2f} GB ({base_gb:.2f} GB of it the weights before "
        f"the call); launches {want}; request "
        f"0's best beam {preds[0]['prediction'][0][:60]!r} score "
        f"{preds[0]['score'][0]:.3f}; on {card}")
    return dict(batch_ms=batch_ms, encoder_ms=enc_ms, decode_step_ms=step_ms,
                busy_ms=busy_ms, windows=windows, steps=steps,
                replays=replays, capture_ms=capture["capture_ms"],
                route=gen.route, peak_gb=peak_gb, weights_gb=base_gb,
                launches=want), preds


def retro_cache_check(cfg, enc_tok, dec_tok, batch) -> dict:
    """The batch generated in f32 with the kernels on, then its 640 final
    sequences rescored by the teacher-forced decoder with the kernels off:
    each sum within rescore_tolerance of its beam score. This holds the
    160-slot grouped cache of 32 x 20 beams, its ancestor table and bias,
    the windows and the kernels together."""
    module, enc_cfg, dec_cfg = build_model(
        dataclasses.replace(cfg, compute_dtype="float32",
                            param_dtype="float32"),
        enc_tok, dec_tok, torch.Generator().manual_seed(0))
    gen = Generator(module, num_beams=RETRO_BEAMS, max_length=RETRO_DEC_LEN)
    reset_counts()
    seqs, scores = gen.generate(batch)
    torch.cuda.synchronize()
    steps = gen.last_steps
    check_beams("retro f32 generate", seqs, scores, steps)
    check_launches("the f32 generate", read_counts(), serving_launches(
        enc_cfg.num_hidden_layers, dec_cfg.num_hidden_layers,
        gen.last_replays))
    set_kernels(module, False)
    before = read_counts()
    t0 = time.perf_counter()
    rescored, n_tokens = teacher_forced_scores(module, batch, seqs, steps,
                                               dec_cfg.eos_token_id)
    rescore_s = time.perf_counter() - t0
    if read_counts() != before:
        raise AssertionError("the plain rescoring launched a kernel")
    diff = np.abs(rescored - scores.astype(np.float64))
    tol = rescore_tolerance(n_tokens, scores)
    worst = float((diff / tol).max())
    log(f"[retro_tf] cache against teacher forcing, f32: {seqs.shape[0]} x "
        f"{RETRO_BEAMS} sequences of {int(n_tokens.min())}-"
        f"{int(n_tokens.max())} scored tokens ({int((n_tokens < steps).sum())}"
        f" ended by EOS), beam scores {float(scores.min()):.2f} to "
        f"{float(scores.max()):.2f}; max |beam - rescored| "
        f"{float(diff.max()):.3e}, max |diff| / tolerance {worst:.3f} "
        f"(bound 1; tolerance {RESCORE_TOKEN_BOUND:g} + 2^-24 |score| a "
        f"token, up to {float(tol.max()):.3e}); rescoring {rescore_s:.1f} s")
    if not worst <= 1.0:
        raise AssertionError("cached beam scores depart from teacher-forced "
                             "rescoring")
    return dict(max_abs_diff=float(diff.max()), max_over_tolerance=worst,
                max_tolerance=float(tol.max()), steps=steps)


def scoring_predictions(beam_lists: list, golds: list, rng) -> dict:
    """SCORING_EXAMPLES examples: example i takes beam list i and gold i
    (both cycled; the two lists are as long), the gold written another way (the molecules in reverse order,
    each from a random atom order), planted at SCORING_RANK."""
    from textreact_tpu_torch.chem import random_smiles
    prediction = {}
    for i in range(SCORING_EXAMPLES):
        beams = list(beam_lists[i % len(beam_lists)])
        gold = golds[i % len(golds)]
        beams[SCORING_RANK - 1] = ".".join(
            random_smiles(s, rng)[0] for s in reversed(gold.split(".")))
        prediction[i] = {"prediction": beams, "score": [0.0] * len(beams)}
    return prediction


def time_retro_scoring(card: str, preds: dict, data: Path) -> dict:
    """evaluate_retrosynthesis with the trainer's worker count on
    SCORING_EXAMPLES x 20 predictions: the serving batch's beams with the
    test split's gold reactants planted at SCORING_RANK, which must read
    back as that rank through the C++ canonicaliser; then the same with
    every beam a real molecule (other reactant sets written from random
    atom orders), as a trained model's beams are."""
    import random
    from textreact_tpu_torch.chem import random_smiles
    from textreact_tpu_torch.evaluation import evaluate_retrosynthesis
    from textreact_tpu_torch.evaluation.retro import TOP_KS
    rng = random.Random(0)
    golds = list(read_csv(str(data / "test.csv"))["reactant_smiles"])
    table = Table({"reactant_smiles": [golds[i % len(golds)]
                                       for i in range(SCORING_EXAMPLES)]})
    workers = min(16, os.cpu_count() or 1)   # as train/trainer.py::test
    want = {k: float(k >= SCORING_RANK) for k in TOP_KS}
    phase_beams = [preds[i]["prediction"] for i in sorted(preds)]
    parsed = sum(native_chem.native_canonical_smiles(s, fallback="") != ""
                 for beams in phase_beams for s in beams)
    # reactant sets of the other rows, none the gold (distinct golds apart)
    others = sorted(set(golds))
    real_beams = []
    for i in range(len(golds)):
        pool = [g for g in others if g != golds[i]]
        real_beams.append([".".join(random_smiles(s, rng)[0]
                                    for s in rng.choice(pool).split("."))
                           for _ in range(RETRO_BEAMS)])
    out = {}
    for name, beam_lists in (("phase_beams", phase_beams),
                             ("real_molecules", real_beams)):
        prediction = scoring_predictions(beam_lists, golds, rng)
        t0 = time.perf_counter()
        accuracy = evaluate_retrosynthesis(prediction, table, RETRO_BEAMS,
                                           num_workers=workers)
        seconds = time.perf_counter() - t0
        if accuracy != want:
            raise AssertionError(f"scoring {name}: {accuracy}, the gold "
                                 f"planted at rank {SCORING_RANK}: {want}")
        out[name] = seconds
    log(f"[retro_tf] host retro scoring, {SCORING_EXAMPLES} examples x "
        f"{RETRO_BEAMS} beams, {workers} workers, the gold planted at rank "
        f"{SCORING_RANK} read back as rank {SCORING_RANK} by the C++ "
        f"canonicaliser: {out['phase_beams']:.2f} s with the serving batch's "
        f"beams ({parsed} of {len(phase_beams) * RETRO_BEAMS} parse), "
        f"{out['real_molecules']:.2f} s with every beam a real molecule; on "
        f"the host of {card}")
    return dict(seconds_phase_beams=out["phase_beams"],
                seconds_real_molecules=out["real_molecules"],
                workers=workers, phase_beams_parsed=parsed)


@contextlib.contextmanager
def timed_calls(module, name: str, seconds: list):
    """Append the seconds of every call of module.name while the block
    runs."""
    fn = getattr(module, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            seconds.append(time.perf_counter() - t0)

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


def recipe_run_launches(sizes: dict, steps: list) -> dict:
    """The launches of one seq2seq recipe through parity_run.py on `sizes`
    reactions (micro-batches of B): its retrieval's three searches, then an
    epoch of training, fit's and --do_valid's validation and a test pass
    on each of the two corpora, whose decode steps (`steps`, one entry a
    test batch) set the decoder's LN and decode attention launches."""
    enc_layers = PRESETS["scibert_base"].num_hidden_layers
    dec_layers = PRESETS["bert_l6"].num_hidden_layers
    ln = 2 * enc_layers + 3 * dec_layers
    mbs = -(-sizes["train"] // B)
    evals = 2 * 2 * -(-sizes["val"] // B)
    tests = 2 * -(-sizes["test"] // B)
    if len(steps) != tests:
        raise AssertionError(f"{len(steps)} test batches, expected {tests}")
    return dict(exact_topk_corpus_split=3,
                fused_attention_fwd=enc_layers * (mbs + evals + tests),
                fused_attention_bwd=enc_layers * mbs,
                fused_layernorm_fwd=ln * (mbs + evals) + 2 * enc_layers
                * tests + 3 * dec_layers * sum(steps),
                fused_layernorm_bwd=ln * mbs,
                grouped_decode_attn=dec_layers * sum(steps))


def retro_recipe(card: str, tmp: Path, data: Path, vocab: Path,
                 results: dict) -> dict:
    """scripts/torch_port/parity_run.py --recipe RetroSyn_tf in-process on
    the fixture's splits: it builds the neighbour files (three searches),
    trains one epoch, validates and tests with beam 20 over 160; launches
    exact, the test pass's LNs from its decode steps."""
    parity_run = parity_run_module()
    save, nn_dir = tmp / "retro_tf_run", tmp / "retro_tf_nn"
    # the cut: one epoch; the SciBERT directory's place taken by the preset
    # and the phase's vocab; the global batch of 128 as 4 x 32 and test
    # batches of 32, as scripts/torch_port/train_RetroSyn_tf.sh has them
    cut = ["--batch_size", str(B), "--gradient_accumulation_steps",
           str(MICRO_BATCHES), "--test_batch_size", str(B), "--epochs", "1"]
    override = ["--encoder", "scibert_base", "--decoder", "bert_l6",
                "--text_vocab_file", str(vocab), *cut, "--log_every", "1",
                "--debug"]
    steps, legs, routes = [], {"retrieval": [], "command": []}, []
    reset_counts()
    t0 = time.perf_counter()
    with counted_decode_steps(steps), trainer_routes(routes), \
            timed_calls(retrieval_cli, "main", legs["retrieval"]), \
            timed_calls(runtime_cli, "main", legs["command"]):
        parity_run.main([
            "--recipe", "RetroSyn_tf", "--data_path", str(data),
            "--corpus_file", str(data / "corpus.csv"),
            "--nn_path", str(nn_dir), "--save_path", str(save),
            "--override", " ".join(override)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    result = json.loads((save / "parity_results.json").read_text())
    if (result["recipe"] != "RetroSyn_tf" or "--shuffle_smiles" not in
            result["argv"] or "160" not in result["argv"]):
        raise AssertionError(f"parity_results.json: {result}")
    check_neighbour_files(data, nn_dir,
                          parity_run.RECIPES["RetroSyn_tf"]["field"])
    sizes = {s: len(read_csv(str(data / f"{s}.csv")))
             for s in ("train", "val", "test")}
    tests = 2 * -(-sizes["test"] // B)      # two corpora each
    launches = recipe_run_launches(sizes, steps)
    check_launches("the RetroSyn_tf run", counts, launches)
    for name, n in launches.items():
        results[name]["launches_retro_tf_run"] = n
    accuracies = [{int(k): v for k, v in acc.items()}
                  for acc in result["accuracy"]]
    if len(accuracies) != 2 or any(
            set(a) != {1, 2, 3, 5, 10, 20}
            or not all(0.0 <= v <= 1.0 for v in a.values())
            for a in accuracies):
        raise AssertionError(f"retro top-k dicts: {accuracies}")
    for li in (0, 1):
        preds = json.loads((save / f"prediction_test_{li}.json").read_text())
        if sorted(map(int, preds)) != list(range(sizes["test"])) or any(
                len(p["prediction"]) != RETRO_BEAMS
                or len(p["score"]) != RETRO_BEAMS for p in preds.values()):
            raise AssertionError(f"prediction_test_{li}.json")
    records = read_metrics(save)
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    if not losses or not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"train_loss records: {losses}")
    timing = [r for r in records if "epoch_seconds" in r][0]
    test_s = sum(r["test_seconds"] for r in records if "test_seconds" in r)
    legs = dict(retrieval=sum(legs["retrieval"]), command=sum(
        legs["command"]), epoch=timing["epoch_seconds"], test=test_s)
    log(f"[retro_tf] RetroSyn_tf through scripts/torch_port/parity_run.py "
        f"in {seconds:.1f} s on {sizes} reactions (parity_run.py's flags, lr "
        f"2e-4, --shuffle_smiles; {' '.join(cut)}): the "
        f"retrieval CLI {legs['retrieval']:.1f} s (three searches), the "
        f"command {legs['command']:.1f} s, of it the epoch "
        f"{legs['epoch']:.1f} s ({timing['epoch_steps']:.0f} optimizer steps of "
        f"{MICRO_BATCHES} x {B}, train_loss "
        f"{', '.join(f'{v:.4f}' for v in losses)}) and the test passes "
        f"{legs['test']:.1f} s ({sum(steps)} decode steps over {tests} "
        f"batches of {B} at beam {RETRO_BEAMS}); retro top-k "
        f"{accuracies[0]} / {accuracies[1]}; launches {launches}; on {card}")
    validation = check_eval_records("retro_tf", records,
                                    2 * -(-sizes["val"] // B))
    return dict(seconds=seconds, legs=legs, decode_steps=sum(steps),
                accuracy=accuracies, launches=launches,
                route=check_trainer_route("retro_tf", routes),
                validation=validation)


def phase_retro_tf(card: str, tmp: Path, vocab: Path, results: dict) -> dict:
    """Template-free retrosynthesis at full width and depth on the template
    fixture's splits: three training steps, kernels against plain
    functions, a serving batch, the f32 cache against teacher forcing, the
    host's scoring, then the recipe through parity_run.py."""
    data = tmp / "template_data"
    if not data.exists():
        write_template_fixture(data)
    cfg = retro_config(data, vocab)
    enc_tok, dec_tok = get_tokenizers(cfg)
    out = {}
    micro, out["train"] = retro_train(card, cfg, enc_tok, dec_tok, results)
    torch.cuda.empty_cache()
    phase_train_kernels_vs_plain(cfg, enc_tok, dec_tok, micro,
                                 dec_tok.pad_token_id, tag="retro_tf")
    del micro
    torch.cuda.empty_cache()
    batch = retro_batch(cfg, enc_tok, dec_tok, "test", B).arrays
    out["serving"], preds = retro_serving(card, cfg, enc_tok, dec_tok, batch,
                                          results)
    torch.cuda.empty_cache()
    out["cache"] = retro_cache_check(cfg, enc_tok, dec_tok, batch)
    torch.cuda.empty_cache()
    out["scoring"] = time_retro_scoring(card, preds, data)
    out["recipe"] = retro_recipe(card, tmp, data, vocab, results)
    return out


# --- 13. curation: raw rows -> curated files -> neighbours -> training -----

# raw condition rows and corpus paragraphs of the phase, from seed 0: 1,000
# rows over condition_reactions()' 256 reactions (a skewed draw, so many
# repeat) and 1,200 paragraphs, a fifth of them repeats of an earlier one
CURATION_ROWS, CURATION_PARAGRAPHS = 1000, 1200
# --remove_threshold: the recipe's 100 would leave too few of 1,000 rows
CURATION_THRESHOLD = 10
# atom-mapped reactions of the template half, a split each
MAPPED_SIZES = {"train": 512, "val": 64, "test": 64}

# catalyst / solvent / reagent combos of the raw rows, most frequent first:
# empty slots, ionic reagents of the asset table (whole, in part, alone),
# a chemical name, and combos that excess removal drops (two catalysts,
# three solvents, three known reagents)
CONDITION_COMBOS = [
    ("", "ClCCl", "CCN(CC)CC"),
    ("", "C1CCOC1", "[Na+].[OH-]"),
    ("", "CN(C)C=O", "O=C([O-])[O-].[K+].[K+]"),
    ("", "ClCCl.CO", "CCN(CC)CC"),
    ("", "CCO", ""),
    ("[Pd]", "C1CCOC1.O", "O=P([O-])([O-])[O-].[K+].[K+].[K+]"),
    ("", "", "CCN(CC)CC.O"),
    ("", "CO", "O.[Li+].[OH-]"),
    ("", "CC#N", "[Cl-].[NH4+]"),
    ("", "ClCCl", "[Na+]"),
    ("", "CCO.O.ClCCl", "O"),
    ("", "C1CCOC1", "[BH4-].[Na+]"),
    ("[Pd].[Cu]", "C1CCOC1", "CCN(CC)CC"),
    ("", "ClCCl", "O.CCO.CCN"),
    ("", "CO", "CCO.sodium methoxide"),
    ("[Cu]", "CN(C)C=O", "[Cs+].[F-]"),
    ("", "CC(C)=O", "[I-].[K+]"),
    ("[Rh]", "CC#N", "CC(C)[N-]C(C)C.[Li+]"),
    ("", "c1ccccc1", "O=S(=O)(O)O"),
    ("[Ni]", "CCOCC", "[H-].[Na+]"),
]


def condition_reactions() -> list:
    """256 distinct unmapped reactions: 12 acid chlorides acylating 14
    alcohols and amines, 8 bromides alkylating 8 amines, 4 sulfonyl
    chlorides sulfonylating 6 amines."""
    acyls = ["C", "CC", "CC(C)", "CCC", "c1ccccc1", "C1CC1", "Fc1ccc(cc1)",
             "COc1ccc(cc1)", "CC(C)(C)", "C=C", "c1ccoc1", "ClCC"]
    nucleophiles = ["OC", "OCC", "OCc1ccccc1", "OC(C)C", "OCCCC",
                    "Oc1ccccc1", "OCC(F)(F)F", "NCC", "NC1CCCCC1",
                    "Nc1ccccc1", "NCCO", "N(C)C", "NCc1ccccc1", "N1CCOCC1"]
    alkyls = ["C", "CC", "CCC", "CC(C)", "c1ccccc1C", "C=CC", "CCCC", "N#CC"]
    amines = ["NCC", "NC1CCCCC1", "Nc1ccccc1", "N(C)C", "N1CCOCC1",
              "N1CCCC1", "NCc1ccccc1", "NCCO"]
    sulfonyls = ["C", "Cc1ccc(cc1)", "c1ccccc1", "CC"]
    out = [f"{a}C(=O)Cl.{n}>>{a}C(=O){n}" for a in acyls for n in nucleophiles]
    out += [f"{a}Br.{n}>>{a}{n}" for a in alkyls for n in amines]
    out += [f"{s}S(=O)(=O)Cl.{n}>>{s}S(=O)(=O){n}"
            for s in sulfonyls for n in amines[:6]]
    return out


def write_raw_conditions(root: Path, rows: int = CURATION_ROWS,
                         paragraphs: int = CURATION_PARAGRAPHS,
                         words: int = 220, seed: int = 0,
                         digit_sources: bool = False) -> None:
    """`conditions.csv` in the schema `parse_cml_reactions` emits (id,
    source, year, patent_type, rxn_smiles, solvent, catalyst, reagent) with
    the columns the mapping stage adds (canonical_rxn, confidence: 1 or a
    two-place decimal), `rows` of them over `condition_reactions()` drawn
    with weights 1/rank and combos of CONDITION_COMBOS with weights
    1/rank^1.3; `patent_info.json` (60 patents of 2005-2016); `corpus.csv`
    in the corpus schema, a paragraph of `words` words for every row and
    more for other reactions of the same patents, a fifth of them a
    repeat of an earlier paragraph. `digit_sources` names the patents by
    digits alone, which pandas reads as ints."""
    import random
    rng = random.Random(seed)
    words_rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    reactions = condition_reactions()
    canonical = [canonical_rxn_smiles(r)[0] for r in reactions]
    patents = [str(7000000 + 13 * i) if digit_sources else f"US{7000000 + 13 * i}"
               for i in range(60)]
    years = {p: 2005 + i % 12 for i, p in enumerate(patents)}
    counter = dict.fromkeys(patents, 0)

    def next_id(patent):
        counter[patent] += 1
        return f"{patent}_{counter[patent] - 1}"

    with open(root / "conditions.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "source", "year", "patent_type", "rxn_smiles",
                    "canonical_rxn", "confidence", "solvent", "catalyst",
                    "reagent"])
        ids = []
        for _ in range(rows):
            r = rng.choices(range(len(reactions)),
                            weights=[1 / (k + 1) for k in
                                     range(len(reactions))])[0]
            c = rng.choices(range(len(CONDITION_COMBOS)),
                            weights=[1 / (k + 1) ** 1.3 for k in
                                     range(len(CONDITION_COMBOS))])[0]
            catalyst, solvent, reagent = CONDITION_COMBOS[c]
            patent = rng.choice(patents)
            ids.append((next_id(patent), patent))
            confidence = 1 if rng.random() < 0.3 else round(
                rng.uniform(0.5, 0.99), 2)
            w.writerow([ids[-1][0], patent, years[patent], "grant",
                        reactions[r], canonical[r], confidence, solvent,
                        catalyst, reagent])
    while len(ids) < paragraphs:
        patent = rng.choice(patents)
        ids.append((next_id(patent), patent))
    texts = []
    for i in range(paragraphs):
        if i and rng.random() < 0.2:
            texts.append(rng.choice(texts))
        else:
            texts.append(" ".join(words_rng.choice(WORDS, words)))
    with open(root / "corpus.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "year", "patent_type", "xml", "heading_text",
                    "paragraph_text"])
        for (rid, patent), text in zip(ids, texts):
            w.writerow([rid, years[patent], "grant", f"{years[patent]}.xml",
                        f"Example {rid.split('_')[1]}", text])
    (root / "patent_info.json").write_text(json.dumps(
        {p: {"year": y, "type": "grant"} for p, y in years.items()}))


def _alkyl(n: int, s: int) -> tuple:
    """A chain of n carbons mapped s (the attachment atom) to s + n - 1:
    (written towards the attachment atom, written from it)."""
    if n == 1:
        return f"[CH3:{s}]", f"[CH3:{s}]"
    inner = [f"[CH2:{s + i}]" for i in range(n - 1)]
    end = f"[CH3:{s + n - 1}]"
    return end + "".join(inner[::-1]), "".join(inner) + end


def _substituent(kind: str, s: int) -> tuple:
    """(written towards the attachment atom, written from it, atoms) of a
    substituent mapped from s, the attachment atom s: an n-carbon chain
    `Cn`, isopropyl, phenyl or benzyl (its CH2 the attachment atom)."""
    if kind.startswith("C"):
        n = int(kind[1:])
        return (*_alkyl(n, s), n)
    if kind == "iPr":
        return (f"[CH3:{s + 1}][CH:{s}]([CH3:{s + 2}])",
                f"[CH:{s}]([CH3:{s + 1}])[CH3:{s + 2}]", 3)

    if kind == "Ph":                  # the ring's carbons s (ipso) to s + 5
        ring = [f"[cH:{s + i}]" for i in range(1, 6)]
        return (ring[0] + "1" + "".join(ring[1:]) + f"[c:{s}]1",
                f"[c:{s}]1" + "".join(ring) + "1", 6)
    ring = [f"[cH:{s + i}]" for i in range(2, 7)]
    return (ring[0] + "1" + "".join(ring[1:]) + f"[c:{s + 1}]1[CH2:{s}]",
            f"[CH2:{s}][c:{s + 1}]1" + "".join(ring) + "1", 7)


SUBSTITUENTS = ["C1", "C2", "C3", "C4", "iPr", "Ph", "Bn"]


def mapped_reaction(family: str, r1: str, r2: str) -> str:
    """An atom-mapped reaction of `family` with substituents r1 and r2
    (reaction centre mapped 1-4, substituents after it)."""
    a_to, a_from, n = _substituent(r1, 5)
    b_to, b_from, _ = _substituent(r2, 5 + n)
    if family == "ester":
        return (f"{a_to}[C:1](=[O:2])[OH:3].[OH:4]{b_from}>>"
                f"{a_to}[C:1](=[O:2])[O:4]{b_from}")
    if family == "amide":
        return (f"{a_to}[C:1](=[O:2])[OH:3].[NH2:4]{b_from}>>"
                f"{a_to}[C:1](=[O:2])[NH:4]{b_from}")
    if family == "sn2":
        return f"[Br:3]{a_from}.[NH2:4]{b_from}>>{a_to}[NH:4]{b_from}"
    if family == "elimination":
        return f"{a_to}[CH:1]([OH:2])[CH3:3]>>{a_to}[CH:1]=[CH2:3]"
    if family == "ether":
        return (f"{a_to}[OH:1].[Br:2][CH2:3]{b_from}>>"
                f"{a_to}[O:1][CH2:3]{b_from}")
    # hydrogenation
    return (f"{a_to}[CH:1]=[CH:2]{b_from}>>"
            f"{a_to}[CH2:1][CH2:2]{b_from}")


MAPPED_FAMILIES = ["ester", "amide", "sn2", "elimination", "ether",
                   "hydrogenation"]


def write_mapped_reactions(root: Path, sizes: dict = MAPPED_SIZES,
                           seed: int = 0) -> None:
    """`{split}.csv` (id, rxn_smiles) of atom-mapped reactions drawn from
    seed `seed`: a family of MAPPED_FAMILIES (the ester, amide, SN2 and
    elimination families of the native extraction tests, Williamson ether
    synthesis and hydrogenation), then two of SUBSTITUENTS (the SN2 family
    alkylates with sp3 carbons only)."""
    import random
    rng = random.Random(seed)
    root.mkdir(parents=True, exist_ok=True)
    for split, n in sizes.items():
        with open(root / f"{split}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "rxn_smiles"])
            for i in range(n):
                family = rng.choice(MAPPED_FAMILIES)
                r1 = rng.choice([s for s in SUBSTITUENTS
                                 if family != "sn2" or s != "Ph"])
                w.writerow([f"{split}_{i}",
                            mapped_reaction(family, r1,
                                            rng.choice(SUBSTITUENTS))])

def run_without_pandas(main: str, argv: list) -> float:
    """`main(argv)` of the port module `main` names, in a child process in
    which `import pandas` fails; seconds, the interpreter's start
    included."""
    module, fn = main.rsplit(".", 1)
    code = ("import sys\nsys.modules['pandas'] = None\n"
            f"from {module} import {fn}\n{fn}(sys.argv[1:])\n")
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-c", code, *map(str, argv)],
                          cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise AssertionError(f"{main} {argv} failed:\n{done.stderr[-3000:]}")
    return time.perf_counter() - t0


def check_curated(raw: Path, out: Path) -> dict:
    """The curated files against what they must hold: no canonical_rxn of
    train in val or test, the vocab the specials and then sorted strings,
    the three splits the filtered rows, an id map entry for every corpus
    row; the rows in and out of each stage."""
    splits = {name: read_csv(str(out / f"{name}.csv"))
              for name in ("train", "val", "test")}
    train_rxns = set(splits["train"]["canonical_rxn"])
    for name in ("val", "test"):
        shared = train_rxns & set(splits[name]["canonical_rxn"])
        if shared or not len(splits[name]):
            raise AssertionError(f"{name}: {len(splits[name])} rows, "
                                 f"{len(shared)} reactions shared with train")
    vocab = (out / "vocab_condition.txt").read_text(
        encoding="utf-8").split("\n")
    if vocab[:len(SPECIALS)] != SPECIALS or vocab[len(SPECIALS):] != sorted(
            vocab[len(SPECIALS):]):
        raise AssertionError(f"vocab_condition.txt: {vocab[:10]}")
    curated = read_csv(str(out / "USPTO_condition.csv"))
    if sum(map(len, splits.values())) != len(curated):
        raise AssertionError(f"splits {[len(s) for s in splits.values()]} "
                             f"do not add up to {len(curated)} rows")
    corpus = read_csv(str(raw / "corpus.csv"))
    id_map = json.loads((out / "id_to_corpus_id.json").read_text())
    if set(id_map) != set(map(str, corpus["id"])):
        raise AssertionError("id_to_corpus_id.json misses corpus rows")
    deduped = read_csv(str(out / "catalyst_freq.csv"))
    return dict(raw_rows=len(read_csv(str(raw / "conditions.csv"))),
                deduplicated_rows=sum(deduped["freq_cnt"]),
                curated_rows=len(curated),
                split_rows={k: len(v) for k, v in splits.items()},
                vocab=len(vocab), corpus_rows=len(corpus),
                corpus_unique=len(read_csv(str(out / "corpus_dedup.csv"))))


@contextlib.contextmanager
def counted_decode_steps(steps: list):
    """Append the decode steps the card ran in every `Generator.generate`
    call while the block runs (`last_replays`: past a stop, those that
    change nothing too): the test pass's residual-LN launches follow from
    them."""
    generate = Generator.generate

    def counted(self, *args, **kw):
        out = generate(self, *args, **kw)
        steps.append(self.last_replays)
        return out

    Generator.generate = counted
    try:
        yield
    finally:
        Generator.generate = generate


def check_template_artifacts(out: Path, raw: Path) -> dict:
    """The processor's files: class ids 1..n in both tables, every label's
    class inside its table, every ProductAtomIdx2CanonIdx a permutation;
    the share of each split's reactions with labels, and of the test rows
    whose gold labels decode back to the reactants (the own template
    engine, as in the retro metric)."""
    n_classes = {}
    for kind in ("atom", "bond"):
        classes = read_csv(str(out / f"{kind}_templates.csv"))["Class"]
        if sorted(classes) != list(range(1, len(classes) + 1)):
            raise AssertionError(f"{kind}_templates.csv classes {classes}")
        n_classes[kind[0]] = len(classes)
    coverage, prediction, rows = {}, {}, []
    for split in ("train", "val", "test"):
        table = read_csv(str(out / f"preprocessed_{split}.csv"))
        if len(table) != len(read_csv(str(raw / f"{split}.csv"))):
            raise AssertionError(f"preprocessed_{split}.csv: {len(table)}")
        labelled = 0
        for i in range(len(table)):
            labels = ast.literal_eval(table["Labels"][i])
            a2c = ast.literal_eval(table["ProductAtomIdx2CanonIdx"][i])
            if sorted(a2c) != list(range(len(a2c))):
                raise AssertionError(f"{split} row {i}: a2c {a2c}")
            if not all(1 <= c <= n_classes[k] for k, _, c in labels):
                raise AssertionError(f"{split} row {i}: labels {labels}")
            labelled += bool(labels)
            if split == "test":
                prediction[i] = {"prediction": [
                    (k, a2c[s] if k == "a" else (a2c[s[0]], a2c[s[1]]), c)
                    for k, s, c in labels], "score": [1.0] * len(labels)}
                rows.append((table["ProductCanonSmiles"][i],
                             demapped_canonical(parse_smiles(
                                 table["Reactants"][i]))))
        coverage[split] = labelled / len(table)
    data = Table({"product_smiles": [p for p, _ in rows]})
    decoded = decode_template_predictions(prediction, data, str(out), top_k=3)
    gold = sum(g in d for (_, g), d in zip(rows, decoded)) / len(rows)
    if coverage["train"] < 0.95 or gold < 0.95:
        raise AssertionError(f"coverage {coverage}, gold decode {gold}")
    return dict(classes=n_classes, coverage=coverage, gold_decode=gold)


def write_template_training_data(out: Path, seed: int = 0) -> None:
    """The trainer's files beside the processor's: `{split}.csv` (id, the
    canonical product, the demapped reactants) row for row with
    `preprocessed_{split}.csv`, a corpus row a training reaction and
    neighbour files of five training ids each (drawn from `seed`)."""
    import random
    rng = random.Random(seed)
    tables = {s: read_csv(str(out / f"preprocessed_{s}.csv"))
              for s in ("train", "val", "test")}
    train_ids = [f"train_{i}" for i in range(len(tables["train"]))]
    for split, table in tables.items():
        Table({"id": [f"{split}_{i}" for i in range(len(table))],
               "product_smiles": table["ProductCanonSmiles"],
               "reactant_smiles": [demapped_canonical(parse_smiles(r))
                                   for r in table["Reactants"]]}
              ).to_csv(str(out / f"{split}.csv"))
        (out / f"{split}_nn.json").write_text(json.dumps(
            [{"id": f"{split}_{i}", "nn": rng.sample(train_ids, 5)}
             for i in range(len(table))]))
    write_corpus(out / "corpus.csv", train_ids, seed)


def parity_run_module():
    """scripts/torch_port/parity_run.py as a module (scripts/ is no
    package)."""
    import importlib.util
    path = Path(__file__).resolve().parent / "scripts/torch_port/parity_run.py"
    spec = importlib.util.spec_from_file_location("torch_port_parity_run",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_neighbour_files(data: Path, nn_dir: Path, field: str) -> None:
    """The neighbour files that the retrieval CLI wrote into `nn_dir` for
    the splits in `data`: a record for each row in order, each with
    min(TOPK_K, train rows) train ids, and on the first 256 rows of each
    split the ids of the numpy oracle in its order (FlatIndex's
    reference_search over the CLI's own train fingerprints; the check of
    the CLI's --check_parity)."""
    train_ids = read_csv(str(data / "train.csv"))["id"]
    corpus = np.load(nn_dir / "train_fp.npy")
    oracle = FlatIndex(corpus, device="cpu")
    fingerprints = retrieval_cli.fingerprint_fn(field, 1)
    k = min(TOPK_K, len(train_ids))
    for name in ("train", "val", "test"):
        table = read_csv(str(data / f"{name}.csv"))
        records = json.loads((nn_dir / f"{name}.json").read_text())
        queries = (corpus[:256] if name == "train"
                   else fingerprints(list(table[field])[:256]))
        _, rank = oracle.reference_search(queries, k=TOPK_K)
        want = [[train_ids[n] for n in nn if 0 <= n < len(train_ids)]
                for nn in rank.tolist()]
        if [r["id"] for r in records] != table["id"] or any(
                len(r["nn"]) != k for r in records) or [
                r["nn"] for r in records[:256]] != want:
            raise AssertionError(f"{nn_dir / name}.json: {len(records)} "
                                 f"records, or not the oracle's neighbours")
    log(f"[curation] {nn_dir.name}: the three neighbour files hold the "
        f"numpy oracle's {k} neighbours in order (first 256 rows a split)")


def phase_curation(card: str, tmp: Path, vocab: Path, results: dict) -> dict:
    """The offline curation on the card's host, then the card: raw
    condition rows through both curation commands (in a process that
    cannot import pandas), the retrieval CLI over the curated splits, the
    RCR recipe at full width on the curated files; mapped reactions through
    the template processor, the RetroSyn_tb recipe on its labels."""
    raw, out, nn_dir = tmp / "curation_raw", tmp / "curated", tmp / "curated_nn"
    seconds = {}
    t0 = time.perf_counter()
    write_raw_conditions(raw)
    seconds["write_raw"] = time.perf_counter() - t0
    seconds["condition_split"] = run_without_pandas(
        "textreact_tpu_torch.preprocess.cli.main",
        ["condition-split", "--input", raw / "conditions.csv",
         "--output_path", out, "--patent_info", raw / "patent_info.json",
         "--remove_threshold", CURATION_THRESHOLD])
    seconds["dedup_corpus"] = run_without_pandas(
        "textreact_tpu_torch.preprocess.cli.main",
        ["dedup-corpus", "--input", raw / "corpus.csv", "--output_path", out])
    rows = check_curated(raw, out)
    log(f"[curation] {rows['raw_rows']} raw condition rows -> "
        f"{rows['deduplicated_rows']} after the duplicates -> "
        f"{rows['curated_rows']} curated ({rows['split_rows']}), vocab "
        f"{rows['vocab']} lines; corpus {rows['corpus_rows']} -> "
        f"{rows['corpus_unique']} paragraphs; condition-split "
        f"{seconds['condition_split']:.1f} s, dedup-corpus "
        f"{seconds['dedup_corpus']:.1f} s, each in a process without pandas")

    # the RCR recipe through scripts/torch_port/parity_run.py, in-process (the
    # launch counters are this process's): no neighbour files in nn_dir, so
    # parity_run builds them with the retrieval CLI (three searches), then
    # trains, validates and tests at full width on the curated files
    parity_run = parity_run_module()
    save = tmp / "curation_run"
    accum = MICRO_BATCHES
    override = [
        "--encoder", "scibert_base", "--decoder", "bert_l6",
        "--encoder_tokenizer", "text", "--text_vocab_file", str(vocab),
        "--vocab_file", str(out / "vocab_condition.txt"),
        "--max_dec_length", str(DEC_LEN), "--batch_size", str(B),
        "--gradient_accumulation_steps", str(accum),
        "--test_batch_size", str(B), "--epochs", "1", "--max_grad_norm", "5",
        "--log_every", "1", "--debug"]
    steps: list = []
    reset_counts()
    t0 = time.perf_counter()
    with counted_decode_steps(steps):
        parity_run.main([
            "--recipe", "RCR", "--data_path", str(out),
            "--corpus_file", str(out / "corpus_dedup.csv"),
            "--nn_path", str(nn_dir), "--save_path", str(save),
            "--override", " ".join(override)])
    torch.cuda.synchronize()
    seconds["rcr_run"] = time.perf_counter() - t0
    counts = read_counts()
    result = json.loads((save / "parity_results.json").read_text())
    accuracies = [{int(k): v for k, v in acc.items()}
                  for acc in result["accuracy"]]
    if "--shuffle_smiles" not in result["argv"] or result["recipe"] != "RCR":
        raise AssertionError(f"parity_results.json: {result}")
    check_neighbour_files(out, nn_dir, parity_run.RECIPES["RCR"]["field"])
    enc_layers = PRESETS["scibert_base"].num_hidden_layers
    records = read_metrics(save)
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    timing = [r for r in records if "epoch_seconds" in r][0]
    rcr_step_ms = timing["epoch_seconds"] / timing["epoch_steps"] * 1e3
    split_rows = rows["split_rows"]
    mbs = -(-split_rows["train"] // B)
    tests = 2 * -(-split_rows["test"] // B)      # two corpora each
    # the recipe's --shuffle_smiles reorders the SMILES of a reaction and
    # changes no shape: the counts are those of the run without it
    check_launches("the RCR run", counts,
                   recipe_run_launches(split_rows, steps))
    launches = dict(counts)
    if not losses or not all(np.isfinite(v) for v in losses) or len(
            accuracies) != 2:
        raise AssertionError(f"RCR run: losses {losses}, {accuracies}")
    log(f"[curation] RCR through scripts/torch_port/parity_run.py (the "
        f"retrieval CLI's three searches, then --shuffle_smiles and the "
        f"recipe's flags with {' '.join(override[-14:])}) at full width on "
        f"the curated files in {seconds['rcr_run']:.1f} s: {mbs} "
        f"micro-batches of {B} ({accum} a step), train_loss "
        f"{', '.join(f'{v:.4f}' for v in losses)}, {rcr_step_ms:.1f} ms per "
        f"optimizer step (epoch 1, its first step included), top-1 "
        f"{accuracies[0][1]:.3f} / {accuracies[1][1]:.3f}, {sum(steps)} "
        f"decode steps over {tests} test batches; launches {counts}, as "
        f"counted without --shuffle_smiles")

    # mapped reactions through the template processor on the host
    mapped, tpl = tmp / "mapped_raw", tmp / "template_curated"
    write_mapped_reactions(mapped)
    # the steps of `python -m textreact_tpu_torch.templates.processor
    # --engine native`, each pass timed
    proc = template_processor.TemplateProcessor(
        str(mapped / "train.csv"), str(mapped / "val.csv"),
        str(mapped / "test.csv"), str(tpl), engine="native")
    proc.check_data_format()
    passes = {}
    for name in ("extract_templates", "match_templates"):
        t0 = time.perf_counter()
        getattr(proc, name)()
        passes[name] = time.perf_counter() - t0
    seconds["template_processor"] = sum(passes.values())
    artifacts = check_template_artifacts(tpl, mapped)
    n_mapped = sum(MAPPED_SIZES.values())
    rates = {"extraction_per_s": MAPPED_SIZES["train"]
             / passes["extract_templates"],
             "labelling_per_s": n_mapped / passes["match_templates"]}
    log(f"[curation] template processor on the host: {n_mapped} mapped "
        f"reactions ({MAPPED_SIZES}) in {seconds['template_processor']:.1f} "
        f"s: extraction {rates['extraction_per_s']:.0f} reactions/s, "
        f"labelling {rates['labelling_per_s']:.0f} reactions/s; classes "
        f"{artifacts['classes']}, labelled shares {artifacts['coverage']}, "
        f"gold labels decode to the reactants on "
        f"{artifacts['gold_decode']:.1%} of the test rows")

    # RetroSyn_tb on the extracted labels, through parity_run's recipe: the
    # templates are there, the neighbour files are not (three searches)
    write_template_training_data(tpl)
    tb_save = tmp / "curation_template_run"
    tb_override = [
        "--encoder", "scibert_base", "--encoder_tokenizer", "smiles_text",
        "--text_vocab_file", str(vocab), "--batch_size", str(B),
        "--gradient_accumulation_steps", str(MICRO_BATCHES),
        "--test_batch_size", str(B), "--epochs", "1", "--max_grad_norm", "5",
        "--num_beams", "20", "--log_every", "1", "--debug"]

    reset_counts()
    t0 = time.perf_counter()
    parity_run.main([
        "--recipe", "RetroSyn_tb", "--data_path", str(tpl),
        "--corpus_file", str(tpl / "corpus.csv"),
        "--template_path", str(tpl), "--nn_path", str(tmp / "tb_nn"),
        "--save_path", str(tb_save), "--override", " ".join(tb_override)])
    torch.cuda.synchronize()
    tb_seconds = time.perf_counter() - t0
    counts = read_counts()
    check_launches("the RetroSyn_tb run", counts, dict(
        template_cli_launches(enc_layers, MAPPED_SIZES),
        exact_topk_corpus_split=3))  # parity_run's retrieval
    check_neighbour_files(tpl, tmp / "tb_nn",
                          parity_run.RECIPES["RetroSyn_tb"]["field"])
    result = json.loads((tb_save / "parity_results.json").read_text())
    cli = check_template_run(
        card, tb_save, MAPPED_SIZES,
        [{int(k): v for k, v in acc.items()} for acc in result["accuracy"]],
        tb_seconds, counts)
    for name, n in cli.pop("launches").items():
        launches[name] += n
    for name in MAIN_KERNELS:
        results[name]["launches_curation"] = launches[name]
    seconds["template_run"] = cli["cli_seconds"]
    return dict(rows=rows, mapped=n_mapped, seconds=seconds, **rates,
                **artifacts, rcr_step_ms=rcr_step_ms,
                template_step_ms=cli["cli_step_ms"], launches=launches)


# --- 14. the multi-device slice --------------------------------------------

# leg B's loss at p = 0 against leg A's, both bf16 at full width: tp adds
# the two ranks' bf16 partial products of every row-split layer in f32, one
# more rounding per layer than one device, through 12 + 6 layers
TP_LOSS_BOUND = 1e-2
# leg D: the JAX gate's bound on beam scores (__graft_entry__.py:516), its
# allclose's: |diff| <= TP_SCORE_BOUND + TP_SCORE_BOUND * |reference|
TP_SCORE_BOUND = 1e-5
PARALLEL_KERNELS = ("fused_attention_fwd", "fused_attention_bwd",
                    "fused_layernorm_fwd", "fused_layernorm_bwd")


def check_head_offset() -> None:
    """The attention kernels on half of a layer's heads with a head offset
    (a tp=2 rank's share) draw the masks of those heads in the whole
    layer: the exported mask against the full one, and the forward and
    backward against the plain version fed the full mask's heads."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    half = HEADS // 2
    seed = _build.draw_seed(gen, dev)
    full = fused_attention.keep_mask(seed, B, HEADS, L, DROPOUT_P)
    for r in (0, 1):
        part = fused_attention.keep_mask(seed, B, half, L, DROPOUT_P,
                                         head_offset=r * half,
                                         total_heads=HEADS)
        if not torch.equal(part, full[:, r * half:(r + 1) * half]):
            raise AssertionError(f"keep mask of heads {r * half}.. differs "
                                 f"from the full layer's")
    log(f"[parallel] keep masks of heads 0-{half - 1} and {half}-"
        f"{HEADS - 1} (offset, total {HEADS}) equal the full layer's, "
        f"B={B} L={L}")
    mask = torch.ones(B, L, dtype=torch.int32, device=dev)
    mask[1, L // 3:] = 0
    scale = HEAD_DIM ** -0.5
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(B, L, half, HEAD_DIM, generator=gen,
                                   device=dev).to(dtype) for _ in range(4))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        state = gen.get_state()
        out = fused_attention.fused_dropout_attention(
            *leaves, mask, DROPOUT_P, gen, scale, head_offset=half,
            total_heads=HEADS)
        out.backward(do)
        keep = fused_attention.keep_mask(drawn_seed(gen, state), B, HEADS, L,
                                         DROPOUT_P)[:, half:]
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = fused_attention.attention_reference(*ref_leaves, mask, scale,
                                                  keep, DROPOUT_P)
        ref.backward(do)
        tag = f"heads {half}-{HEADS - 1} of {HEADS} {str(dtype)[6:]}"
        check_close(f"{tag} out", out, ref, *ATTN_TOL[dtype])
        for name, a, b in zip("qkv", leaves, ref_leaves):
            check_close(f"{tag} d{name}", a.grad, b.grad, *GRAD_TOL[dtype])


def parallel_train(cfg, enc_tok, dec_tok, micro, mesh, p: float,
                   steps: int, device="cuda", zero1: bool = False,
                   module=None):
    """(module, state, metrics of each step, host ms of each step):
    `steps` accumulated optimizer steps at dropout p of the RCR training
    model built from seed 0, cut by `mesh` (None: one device)."""
    from textreact_tpu_torch.parallel import shard_params
    if module is None:
        module, _, _ = build_model(cfg, enc_tok, dec_tok,
                                   torch.Generator().manual_seed(0),
                                   device=device)
        shard_params(mesh, module)
    set_dropout(module, p)
    cfg = dataclasses.replace(cfg, zero1=zero1)
    optimizer = make_optimizer(cfg, TRAIN_STEPS, module.named_parameters(),
                               mesh=mesh, tp_axes=module.tp_axes)
    state = TrainState.create(module, optimizer)
    step = make_accum_train_step(module, cfg, optimizer,
                                 dec_tok.pad_token_id, device=device)
    weights = np.ones(MICRO_BATCHES, np.float32)
    history, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, micro, weights, cfg.seed)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in metrics.items()})
    return module, state, history, ms


def _world(tag: str, world_size: int, backend: str) -> str:
    return (f"[parallel] leg {tag}: backend {backend}, world size "
            f"{world_size}, torch.cuda.device_count() "
            f"{torch.cuda.device_count()}")


def tp_train_rank(rank: int, world_size: int, device: str, vocab: str,
                  out: str) -> None:
    """Leg B, one rank of dp=1 x tp=2 at full width: one step at p = 0,
    three at p = 0.1; the replicated parameters compared over the tp
    group; rank 0 writes what it saw."""
    import torch.distributed as dist

    from textreact_tpu_torch.parallel import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_config(Path(vocab))
    enc_tok, dec_tok = get_tokenizers(cfg)
    micro = as_microbatches(make_train_batch(cfg, enc_tok, dec_tok,
                                             cfg.batch_size), MICRO_BATCHES)
    mesh = make_mesh(1, 2)
    reset_counts()
    module, state, first, _ = parallel_train(cfg, enc_tok, dec_tok, micro,
                                             mesh, 0.0, 1, device)
    set_dropout(module, DROPOUT_P)
    step = make_accum_train_step(module, cfg, state.optimizer,
                                 dec_tok.pad_token_id, device=device)
    weights = np.ones(MICRO_BATCHES, np.float32)
    history, ms = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, micro, weights, cfg.seed)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in metrics.items()})
    counts = read_counts()
    heads = {m.num_heads for m in module.modules()
             if hasattr(m, "head_offset")}
    unequal = []
    for name, prm in module.named_parameters():
        if name in module.tp_axes:
            continue
        pieces = [torch.empty(prm.shape) for _ in range(2)]
        dist.all_gather(pieces, prm.detach().cpu(), group=mesh.tp_group)
        if not torch.equal(pieces[0], pieces[1]):
            unequal.append(name)
    if rank == 0:
        Path(out).write_text(json.dumps({
            "loss_p0": first[0]["train_loss"], "history": history, "ms": ms,
            "counts": counts, "local_heads": sorted(heads),
            "unequal": unequal, "backend": dist.get_backend(),
            "world": world_size,
            "device_count": torch.cuda.device_count()}))


def generate_config(vocab: Path) -> ExperimentConfig:
    """The serving recipe in float32 (leg D's comparison is tight)."""
    return dataclasses.replace(base_config(vocab), compute_dtype="float32",
                               param_dtype="float32")


def tp_generate_rank(rank: int, world_size: int, device: str, vocab: str,
                     out: str) -> None:
    """Leg D, one rank of dp=1 x tp=2: beam-15 generation on tp-sharded
    f32 parameters; rank 0 writes the beams."""
    import torch.distributed as dist

    from textreact_tpu_torch.parallel import make_mesh, shard_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = generate_config(Path(vocab))
    enc_tok, dec_tok = get_tokenizers(cfg)
    module, _, _ = build_model(cfg, enc_tok, dec_tok,
                               torch.Generator().manual_seed(0),
                               device=device)
    shard_params(make_mesh(1, 2), module)
    reset_counts()
    gen = Generator(module, num_beams=BEAMS, max_length=DEC_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seqs, scores = gen.generate(make_requests(enc_tok, B, L))
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    if rank == 0:
        np.savez(out, seqs=seqs, scores=scores)
        Path(out + ".json").write_text(json.dumps({
            "counts": read_counts(), "steps": gen.last_steps,
            "replays": gen.last_replays, "route": gen.route,
            "windows": _plan_windows(DEC_LEN, gen.attn_windows),
            "batch_ms": batch_ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "backend": dist.get_backend(), "world": world_size,
            "device_count": torch.cuda.device_count()}))


def leg_a(card, cfg, enc_tok, dec_tok, micro, ref_hist, ref_ms, ref_params,
          bare_step_ms, results) -> dict:
    """Leg A in this process, a world of one: 3 steps at p=0 against one
    device's (`ref_hist`, `ref_params`), then 3 at p=0.1, timed."""
    import torch.distributed as dist

    from textreact_tpu_torch.parallel import make_mesh
    log(_world("A", dist.get_world_size(), dist.get_backend()))
    mesh = make_mesh(1, 1)
    reset_counts()
    module, _, hist, ms = parallel_train(cfg, enc_tok, dec_tok, micro, mesh,
                                         0.0, TRAIN_STEPS, zero1=True)
    if hist != ref_hist:
        raise AssertionError(f"leg A at p=0: {hist} != one device {ref_hist}")
    same = [n for n, p in module.named_parameters()
            if not torch.equal(p.detach(), ref_params[n])]
    if same:
        raise AssertionError(f"leg A: {len(same)} parameters differ from "
                             f"one device's, e.g. {same[:3]}")
    log(f"[parallel] leg A, p=0, {TRAIN_STEPS} steps: losses "
        f"{[h['train_loss'] for h in hist]} and all "
        f"{len(ref_params)} parameter tensors equal to one device's to the "
        f"bit")
    del module, ref_params
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    _, _, hist_p, ms_p = parallel_train(cfg, enc_tok, dec_tok, micro, mesh,
                                        DROPOUT_P, TRAIN_STEPS, zero1=True)
    counts = read_counts()
    for name in PARALLEL_KERNELS:
        if not counts[name] > 0:
            raise AssertionError(f"leg A launched no {name}")
        results[name]["launches_parallel"] = counts[name]
    if not hist_p[-1]["train_loss"] < hist_p[0]["train_loss"]:
        raise AssertionError(f"leg A at p=0.1: the loss did not fall {hist_p}")
    med_a = statistics.median(ms_p[1:])
    log(f"[parallel] leg A, p=0.1: losses "
        f"{[round(h['train_loss'], 4) for h in hist_p]}, "
        f"{med_a:.1f} ms per optimizer step (host clock, median of steps "
        f"2-{TRAIN_STEPS}) beside the train phase's {bare_step_ms:.1f}; at "
        f"p=0 {statistics.median(ref_ms[1:]):.1f} one device, "
        f"{statistics.median(ms[1:]):.1f} leg A; launches {counts}; on "
        f"{card}")
    return {"backend": dist.get_backend(), "world": 1,
            "device_count": torch.cuda.device_count(),
            "ms_p01": med_a, "train_phase_ms": bare_step_ms,
            "ms_p0_one_device": statistics.median(ref_ms[1:]),
            "ms_p0": statistics.median(ms[1:]),
            "loss_p0": hist[0]["train_loss"], "history_p0": hist}


def leg_d(tmp: Path, vocab: Path, backend: str, devices) -> dict:
    """Leg D: tp=2 beam-15 generation at f32 against the unsharded model."""
    from textreact_tpu_torch.parallel.multihost import spawn
    gcfg = generate_config(vocab)
    enc_tok, dec_tok = get_tokenizers(gcfg)
    module, _, _ = build_model(gcfg, enc_tok, dec_tok,
                               torch.Generator().manual_seed(0))
    ref = Generator(module, num_beams=BEAMS, max_length=DEC_LEN)
    ref_seqs, ref_scores = ref.generate(make_requests(enc_tok, B, L))
    del module, ref
    torch.cuda.empty_cache()
    out = str(tmp / "leg_d.npz")
    spawn("chip_smoke:tp_generate_rank", 2,
          {"vocab": str(vocab), "out": out}, backend=backend,
          devices=devices, threads=None, timeout=600)
    d = json.loads(Path(out + ".json").read_text())
    got = np.load(out)
    log(_world("D", d["world"], d["backend"]) + f" (rank 0 saw "
        f"{d['device_count']})")
    if not np.array_equal(got["seqs"], ref_seqs):
        rows = np.nonzero((got["seqs"] != ref_seqs).any((1, 2)))[0]
        raise AssertionError(f"leg D: beams differ in requests {rows}")
    diff = np.abs(got["scores"] - ref_scores)
    err = float(diff.max())
    share = float((diff / (TP_SCORE_BOUND
                           + TP_SCORE_BOUND * np.abs(ref_scores))).max())
    if d["route"] != "uncaptured":
        raise AssertionError(f"leg D: tp=2 took the {d['route']} route")
    log(f"[parallel] leg D: B={B} L={L} beam {BEAMS}, windows "
        f"{d['windows']}, {d['steps']} decode steps in {d['replays']} "
        f"calls, route {d['route']} (the unsharded reference: cuda_graphs), "
        f"f32: sequences "
        f"identical to the unsharded model's, scores max |diff| {err:.3e}, "
        f"max |diff| / ({TP_SCORE_BOUND:g} + {TP_SCORE_BOUND:g} * |ref|) = "
        f"{share:.3f} (bound 1); rank 0's launches {d['counts']}, its first "
        f"(cold) batch {d['batch_ms']:.1f} ms on the host clock, peak "
        f"device memory {d['peak_gb']:.2f} GB (two ranks share the card)")
    if not share <= 1.0:
        raise AssertionError("leg D: beam scores depart")
    if not d["counts"]["fused_attention_fwd"] > 0:
        raise AssertionError("leg D launched no attention kernel")
    return {"backend": d["backend"], "world": d["world"],
            "route": d["route"],
            "device_count": d["device_count"], "score_err": err,
            "score_share": share}


def phase_parallel(card: str, tmp: Path, vocab: Path, bare_step_ms: float,
                   results: dict) -> dict:
    """Legs A-D of the multi-device slice (see the module's docstring)."""
    import torch.distributed as dist

    from textreact_tpu_torch.parallel.multihost import (
        initialize_distributed, spawn)
    report: dict = {}
    check_head_offset()

    # leg A: one process, NCCL, world size 1, dp=1 x tp=1, ZeRO-1 on. The
    # two p=0 runs take torch's deterministic algorithms: the embedding
    # tables' gradients otherwise sum by atomics in any order, and two
    # runs of one device differ in their last bits
    cfg = train_config(vocab)
    enc_tok, dec_tok = get_tokenizers(cfg)
    micro = as_microbatches(make_train_batch(cfg, enc_tok, dec_tok,
                                             cfg.batch_size), MICRO_BATCHES)
    torch.use_deterministic_algorithms(True, warn_only=True)
    ref_module, _, ref_hist, ref_ms = parallel_train(
        cfg, enc_tok, dec_tok, micro, None, 0.0, TRAIN_STEPS)
    ref_params = {n: p.detach().clone()
                  for n, p in ref_module.named_parameters()}
    del ref_module
    torch.cuda.empty_cache()
    initialize_distributed("file://" + str(tmp / "leg_a_store"), 1, 0,
                           backend="nccl", device="cuda:0")
    try:
        report["A"] = leg_a(card, cfg, enc_tok, dec_tok, micro, ref_hist,
                            ref_ms, ref_params, bare_step_ms, results)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()   # else NCCL holds the exit
    hist0 = report["A"].pop("history_p0")
    torch.cuda.empty_cache()

    # legs B and D: two ranks; on one card two processes share it over
    # gloo (NCCL refuses two ranks on one device)
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    devices = (["cuda:0", "cuda:1"] if cards >= 2 else ["cuda:0", "cuda:0"])
    out = tmp / "leg_b.json"
    t0 = time.perf_counter()
    spawn("chip_smoke:tp_train_rank", 2,
          {"vocab": str(vocab), "out": str(out)}, backend=backend,
          devices=devices, threads=None, timeout=900)
    b = json.loads(out.read_text())
    log(_world("B", b["world"], b["backend"]) + f" (rank 0 saw "
        f"{b['device_count']}), {time.perf_counter() - t0:.0f} s")
    err = abs(b["loss_p0"] - hist0[0]["train_loss"])
    log(f"[parallel] leg B, p=0: loss {b['loss_p0']:.6f} vs leg A "
        f"{hist0[0]['train_loss']:.6f}, |diff| {err:.3e} (bound "
        f"{TP_LOSS_BOUND:g})")
    if not err <= TP_LOSS_BOUND:
        raise AssertionError("leg B's loss departs from leg A's")
    if b["unequal"]:
        raise AssertionError(f"leg B: replicated parameters differ across "
                             f"the tp ranks: {b['unequal'][:5]}")
    if b["local_heads"] != [HEADS // 2]:
        raise AssertionError(f"leg B's attention ran {b['local_heads']} heads")
    for name in PARALLEL_KERNELS:
        if not b["counts"][name] > 0:
            raise AssertionError(f"leg B launched no {name}")
    med_b = statistics.median(b["ms"][1:])
    log(f"[parallel] leg B, p=0.1: losses "
        f"{[round(h['train_loss'], 4) for h in b['history']]}; every "
        f"replicated parameter equal to the bit on both tp ranks after "
        f"{TRAIN_STEPS} steps; attention at {HEADS // 2} heads a rank; rank "
        f"0's launches {b['counts']}; {med_b:.1f} ms per optimizer step "
        f"(host clock, median of steps 2-{TRAIN_STEPS})")
    report["B"] = {"backend": b["backend"], "world": b["world"],
                   "device_count": b["device_count"], "ms_p01": med_b,
                   "loss_p0": b["loss_p0"], "loss_p0_err": err}

    # leg C: the corpus-sharded index, two shards on the card(s)
    corpus, queries, banned = retrieval_data("bench")
    shards = ([f"cuda:{i}" for i in range(2)] if cards >= 2
              else ["cuda:0", "cuda:0"])
    whole = FlatIndex(corpus)
    sharded = FlatIndex(corpus, devices=shards)
    one = whole.search(queries, k=TOPK_K)
    reset_counts()
    got = sharded.search(queries, k=TOPK_K)
    counts = read_counts()
    for a, c in zip(got, one):
        if not np.array_equal(a, c):
            raise AssertionError("leg C: sharded index differs from one")
    oracle = sharded.reference_search(queries[:64], k=TOPK_K)
    for a, c in zip(got, oracle):
        if not np.array_equal(a[:64], c):
            raise AssertionError("leg C: sharded index differs from the "
                                 "numpy oracle")
    launches = counts["exact_topk_corpus_split"]
    if not launches > 0:
        raise AssertionError("leg C launched no corpus-split scan")
    results["exact_topk_corpus_split"]["launches_parallel"] = launches
    ms_whole = wall_ms(lambda: whole.search(queries, k=TOPK_K))
    ms_sharded = wall_ms(lambda: sharded.search(queries, k=TOPK_K))
    log(_world("C", 1, "none (one process, one shard a device)"))
    log(f"[parallel] leg C: {len(shards)} shards on {shards}, N = "
        f"{corpus.shape[0]} x {corpus.shape[1]}, {len(queries)} queries, "
        f"k={TOPK_K}: equal to the unsharded index (all queries) and to the "
        f"numpy oracle (first 64) to the bit; {launches} scan launches; "
        f"numpy in to numpy out {ms_sharded:.2f} ms sharded, {ms_whole:.2f} "
        f"ms unsharded (host clock, median of 5)")
    report["C"] = {"shards": shards, "ms": ms_sharded,
                   "ms_unsharded": ms_whole,
                   "device_count": torch.cuda.device_count()}
    del whole, sharded, corpus
    torch.cuda.empty_cache()

    report["D"] = leg_d(tmp, vocab, backend, devices)
    return report

# the measurement tools (phase 15): bench_train's configurations
# (layernorm_impl, mlm_impl) at B = 32, and a soak of SOAK_MINUTES with the
# eval and checkpoint cadences cut to SOAK_CADENCES seconds, so both fire
# (half a minute: ten windows of 50 steps, room for the eval step's phases
# in the run's time)
BENCH_TRAIN_CONFIGS = (("fused", "fused"), ("xla", "fused"), ("fused", "xla"))
SOAK_MINUTES, SOAK_CADENCES = 0.5, (10.0, 20.0)
# the captures (`--captures`): the full soak and the RCR-scale corpus
CAPTURE_SOAK_MINUTES, CAPTURE_BENCH_N = 6, 700_000


def bench_train_launches(enc_layers: int, dec_layers: int,
                         layernorm_impl: str) -> dict:
    """bench_train's kernel launches per step (bench_train.launches' keys):
    the encoder's attention, forward and backward, a residual LN after each
    encoder attention and FFN and each decoder self-attention,
    cross-attention and FFN unless LN takes the plain path; nothing else
    (the decoder's 16 positions take the plain causal attention)."""
    ln = 2 * enc_layers + 3 * dec_layers if layernorm_impl == "fused" else 0
    return {"attention_fwd": enc_layers, "attention_bwd": enc_layers,
            "causal_attention_fwd": 0, "causal_attention_bwd": 0,
            "layernorm_fwd": ln, "layernorm_bwd": ln, "topk": 0}


def phase_bench(card: str) -> dict:
    """The port's measurement tools through their entry points:
    `bench.run` at its card shape (parity before timing; exactly one
    launch of a layout's kernel per search), `bench_train.Bench` at B = 32
    in BENCH_TRAIN_CONFIGS (exact launches per step), and a soak of
    SOAK_MINUTES with the cadences cut to SOAK_CADENCES (an eval and a
    checkpoint fire, no kernel is built, every window launches alike; the
    drift is reported against the tool's bound, see the module's
    docstring). Each tool's JSON line is printed. Returns the lines and
    the counts."""
    t0 = time.perf_counter()
    reset_counts()
    out = bench.run("cuda")
    bench.report(out, log=lambda msg: log(f"[bench] {msg}"))
    for name, layout in out["layouts"].items():
        expect = {other: float(other == name) for other in out["layouts"]}
        if layout["launches_per_search"] != expect:
            raise AssertionError(f"bench {name}: launches per search "
                                 f"{layout['launches_per_search']}, "
                                 f"expected {expect}")
    record = out["record"]
    if (set(record) != {"metric", "value", "unit", "vs_baseline"}
            or record["metric"] != bench.METRIC
            or not record["value"] > 0 or "device-only" not in record["unit"]
            or f"cuda {out['default']}" not in record["unit"]):
        raise AssertionError(f"bench's line: {record}")
    log(f"[bench] {json.dumps(record)}")
    report = {"bench": record, "bench_layouts": out["layouts"]}
    log(f"[time] bench done in {time.perf_counter() - t0:.0f} s")

    enc_cfg, dec_cfg = bench_train.model_configs("fused")
    for ln, mlm in BENCH_TRAIN_CONFIGS:
        tool = bench_train.Bench(B, ln, mlm, "cuda")
        res = tool.throughput()
        expect = bench_train_launches(enc_cfg.num_hidden_layers,
                                      dec_cfg.num_hidden_layers, ln)
        if res["launches_per_step"] != expect:
            raise AssertionError(f"bench_train ln={ln} mlm={mlm}: launches "
                                 f"per step {res['launches_per_step']}, "
                                 f"expected {expect}")
        if not (math.isfinite(res["loss"]) and res["record"]["value"] > 0):
            raise AssertionError(f"bench_train ln={ln} mlm={mlm}: {res}")
        log(f"[bench_train] ln={ln} mlm={mlm}: {res['step_ms']:.2f} ms a "
            f"step (host clock), device span {res['device_ms']:.2f} ms a "
            f"step (CUDA events, 10 steps), loss {res['loss']:.4f}, "
            f"launches per step as expected: {res['launches_per_step']}")
        log(f"[bench_train] {json.dumps(res['record'])}")
        report[f"bench_train_ln_{ln}_mlm_{mlm}"] = dict(
            res["record"], step_ms=res["step_ms"],
            device_ms=res["device_ms"])
        del tool
        torch.cuda.empty_cache()
    log(f"[time] bench_train done in {time.perf_counter() - t0:.0f} s")

    cadences = bench_train.EVAL_EVERY_S, bench_train.CKPT_EVERY_S
    bench_train.EVAL_EVERY_S, bench_train.CKPT_EVERY_S = SOAK_CADENCES
    try:
        tool = bench_train.Bench(B, "fused", "fused", "cuda")
        soak, problems = tool.soak(SOAK_MINUTES,
                                   log=lambda m: log(f"[soak] {m}"))
        tool_route = tool.step.route
    finally:
        bench_train.EVAL_EVERY_S, bench_train.CKPT_EVERY_S = cadences
    del tool
    torch.cuda.empty_cache()
    log(f"[soak] {json.dumps(soak)}")
    fired = {key: int(re.search(key + r"=(\d+)", soak["unit"]).group(1))
             for key in ("evals", "ckpts")}
    drift = problems.pop("drift", None)
    if problems or not min(fired.values()) >= 1:
        raise AssertionError(f"soak: {problems}, fired {fired}")
    drift_pct = re.search(r"drift=(-?[\d.]+)%", soak["unit"]).group(1)
    log(f"[soak] evals and checkpoints fired {fired}, no kernel built, the "
        f"same launches in every window; the step-time drift {drift_pct}% "
        + (f"is over the tool's {bench_train.DRIFT_LIMIT:.0%} bound"
           if drift else
           f"is within the tool's {bench_train.DRIFT_LIMIT:.0%} bound")
        + f" (train step route {tool_route})")
    report["soak"] = dict(soak, drift_within_bound=drift is None)
    counts = read_counts()
    log(f"[bench] launches of the phase: {counts}")
    for name in (*TOPK_LAYOUTS.values(), "fused_attention_fwd",
                 "fused_attention_bwd", "fused_layernorm_fwd",
                 "fused_layernorm_bwd"):
        if not counts[name] > 0:
            raise AssertionError(f"{name} was not launched by the tools")
    report["launches"] = counts
    log(f"[time] soak done in {time.perf_counter() - t0:.0f} s")
    return report


def run_tool(argv: list, env: Optional[dict] = None) -> dict:
    """A measurement tool as a user runs it, in a child process: its output
    logged, its last line parsed, with its exit code and, where it failed,
    its error's last line."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *argv], capture_output=True,
                          text=True, env=dict(os.environ, **(env or {})))
    for line in proc.stdout.splitlines():
        log(f"[capture] {line}")
    log(f"[capture] {' '.join(argv)} {env or ''}: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.0f} s")
    lines = proc.stdout.strip().splitlines()
    if not lines:
        raise AssertionError(f"{argv}: no output\n{proc.stderr[-4000:]}")
    error = proc.stderr.strip().splitlines()[-1:] if proc.returncode else []
    return dict(json.loads(lines[-1]), exit=proc.returncode,
                error=error[0] if error else None)


def captures() -> dict:
    """The captures the tools' short runs cannot give: `bench` on the
    USPTO-condition-scale corpus (BENCH_N=700000), which must pass, and
    bench_train's soak at its real cadences (--soak 6: an eval every
    120 s, a checkpoint at 300 s), which may fail on its step-time drift
    alone (reported; see phase_bench)."""
    out = {"bench_700k": run_tool(["textreact_tpu_torch.bench"],
                                  {"BENCH_N": str(CAPTURE_BENCH_N)}),
           "soak_6min": run_tool(["textreact_tpu_torch.bench_train",
                                  "--soak", str(CAPTURE_SOAK_MINUTES)])}
    bench_ok = out["bench_700k"]["exit"] == 0
    soak = out["soak_6min"]
    soak_ok = soak["exit"] == 0 or re.fullmatch(
        r"SOAK FAILED: drift=-?[\d.]+% \(\|limit\| 2%\)", soak["error"] or "")
    if not (bench_ok and soak_ok):
        raise AssertionError(f"captures: {out}")
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description="Drive the port once on one GPU")
    ap.add_argument("--captures", action="store_true",
                    help="run only the measurement tools' long captures: "
                         "bench at BENCH_N=700000 and bench_train --soak 6")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    if args.captures:
        print(json.dumps({"captures": captures()}))
        return finish(t_start)
    results: dict = {"eval": {}}
    phase_kernels(results)
    log(f"[time] kernels phase done at {time.perf_counter() - t_start:.0f} s")
    decode = phase_decode_attention(results)
    with tempfile.TemporaryDirectory() as tmp:
        vocab = Path(tmp) / "vocab.txt"
        write_text_vocab(vocab)
        phase_serving(card, vocab, results)
        torch.cuda.empty_cache()
        log(f"[time] serving done at {time.perf_counter() - t_start:.0f} s")
        cfg, enc_tok, dec_tok, micro, bare_step_ms = phase_train(
            card, vocab, results)
        torch.cuda.empty_cache()
        phase_train_pad_microbatch(cfg, enc_tok, dec_tok, micro, Path(tmp))
        phase_train_kernels_vs_plain(cfg, enc_tok, dec_tok, micro,
                                     dec_tok.pad_token_id)
        del cfg, enc_tok, dec_tok, micro
        torch.cuda.empty_cache()
        log(f"[time] training done at {time.perf_counter() - t_start:.0f} s")
        phase_retrieval(card, results)
        phase_retrieval_cli(Path(tmp))
        log(f"[time] retrieval done at {time.perf_counter() - t_start:.0f} s")
        phase_shapes(card, Path(tmp), vocab, results)
        log(f"[time] shapes done at {time.perf_counter() - t_start:.0f} s")
        phase_causal_path(card, results)
        log(f"[time] causal path done at "
            f"{time.perf_counter() - t_start:.0f} s")
        phase_runtime(card, Path(tmp), vocab, bare_step_ms, results)
        torch.cuda.empty_cache()
        log(f"[time] runtime done at {time.perf_counter() - t_start:.0f} s")
        phase_pretrained(card, Path(tmp), vocab, bare_step_ms, results)
        torch.cuda.empty_cache()
        log(f"[time] pretrained done at "
            f"{time.perf_counter() - t_start:.0f} s")
        phase_template(card, Path(tmp), vocab, results)
        torch.cuda.empty_cache()
        log(f"[time] template done at {time.perf_counter() - t_start:.0f} s")
        retro_tf = phase_retro_tf(card, Path(tmp), vocab, results)
        torch.cuda.empty_cache()
        log(f"[time] retro_tf done at {time.perf_counter() - t_start:.0f} s")
        curation = phase_curation(card, Path(tmp), vocab, results)
        torch.cuda.empty_cache()
        log(f"[time] curation done at {time.perf_counter() - t_start:.0f} s")
        tools = phase_bench(card)
        log(f"[time] measurement tools done at "
            f"{time.perf_counter() - t_start:.0f} s")
        parallel = phase_parallel(card, Path(tmp), vocab, bare_step_ms,
                                  results)
    train = results.pop("train_routes")
    runtime = results.pop("runtime")
    pretrained = results.pop("pretrained")
    template = results.pop("template")
    evals = results.pop("eval")
    for name in KERNELS:
        if not results[name].get("launches", 0) > 0:
            raise AssertionError(f"{name} was not launched on the main path")
    kernels = [dict(name=name, **meta, **results[name])
               for name, meta in KERNELS.items()]
    print(json.dumps({"train": train}))
    print(json.dumps({"runtime": runtime}))
    print(json.dumps({"pretrained": pretrained}))
    print(json.dumps({"template": template}))
    print(json.dumps({"retro_tf": retro_tf}))
    print(json.dumps({"curation": curation}))
    print(json.dumps({"tools": tools}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"eval": evals}))
    print(json.dumps({"decode_attention": decode}))
    print(json.dumps({"kernels": kernels}))
    return finish(t_start)


def finish(t_start: float) -> int:
    """The card's name and power limit, then the contract's last line."""
    log(f"[time] done in {time.perf_counter() - t_start:.0f} s")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
