"""Device times of the residual-LN kernels at the main path's shapes.

    python scripts/torch_port/layernorm_sweep.py [--parent DIR | --trees DIR ...]
        [--out FILE]

One run times `textreact_tpu_torch.ops.fused_layernorm` as it is found on
the import path, bf16, on the card, at the shapes the recipes give it:
16384 x 768 (the encoder's rows of a micro-batch of 32 at L = 512), 512 x
768 (the decoder's in training), 480 x 768 (a decode step's, 32 x beam
15: serving's call, p = 0, no statistics) and 16384 x 2048 (the wide
route). For each: the forward at p = 0 under no_grad, at p = 0.1 writing
mean and rstd (the call, which draws its seed, and the kernel alone on a
seed drawn beforehand), the backward at p = 0.1 on that forward, and the
one PyTorch call that computes the backward at p = 0
(`aten.native_layer_norm_backward`, a yardstick the port never calls);
each beside its byte bound at 3.35 TB/s and beside PyTorch's own streaming
kernels over the same bytes (`torch.add(x, y)`: the forward's two reads
and a write; `torch.add(x, y)` then `torch.mul(g, 2)`: the backward's
three reads and two writes), what an elementwise pass reaches on the card.

With --parent, the script runs itself in child processes on DIR's package
(a checkout of another commit, built in DIR) and on this tree's, in the
order parent, this, this, parent, so that both are timed on one card in
one call, and prints each run's JSON line; --trees runs it once on each
checkout given, in that order. Device time: CUDA events around
each call, all queued behind a few ms of held work, median of 20 calls.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PEAK_BYTES_PER_S = 3.35e12
DROPOUT_P = 0.1
EPS = 1e-5
# (rows, hidden, timed at p = 0.1 with grad)
SHAPES = ((16384, 768, True), (512, 768, True), (480, 768, False),
          (16384, 2048, True))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run_one() -> dict:
    import torch
    import torch.nn.functional as F

    from textreact_tpu_torch.ops import _build, fused_layernorm as fl

    if not torch.cuda.is_available():
        raise SystemExit("layernorm_sweep: no CUDA device")
    blocker = torch.zeros(8192, 8192, dtype=torch.bfloat16, device="cuda")

    def time_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        for _ in range(40):       # ~60 ms of held work
            torch.mm(blocker, blocker)
        pairs = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    def bound(nbytes):
        return nbytes / PEAK_BYTES_PER_S * 1e3

    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card(), "package": str(Path(fl.__file__).parents[1]),
              "shapes": []}
    for rows, hidden, train in SHAPES:
        x, y, g = (torch.randn(rows, hidden, generator=gen,
                               device="cuda").bfloat16() for _ in range(3))
        w = 1.0 + 0.1 * torch.randn(hidden, generator=gen, device="cuda")
        b = 0.1 * torch.randn(hidden, generator=gen, device="cuda")
        size = x.numel() * x.element_size()
        row = {"rows": rows, "hidden": hidden,
               "bound_fwd_p0_ms": bound(3 * size + 2 * hidden * 4),
               "bound_fwd_ms": bound(3 * size + 2 * hidden * 4 + 8 * rows),
               "bound_bwd_ms": bound(5 * size + 3 * hidden * 4 + 8 * rows)}
        o1, o2 = torch.empty_like(x), torch.empty_like(x)
        row["stream_fwd_bytes_ms"] = time_ms(lambda: torch.add(x, y, out=o1))
        row["stream_bwd_bytes_ms"] = time_ms(
            lambda: (torch.add(x, y, out=o1), torch.mul(g, 2.0, out=o2)))
        with torch.no_grad():
            row["library_fwd_two_calls_ms"] = time_ms(
                lambda: F.layer_norm(x + y, (hidden,), w.bfloat16(),
                                     b.bfloat16(), EPS))
            if train:
                z = x + y
                _, mu, rs = torch.ops.aten.native_layer_norm(
                    z, (hidden,), w.bfloat16(), b.bfloat16(), EPS)
                row["library_bwd_ms"] = time_ms(
                    lambda: torch.ops.aten.native_layer_norm_backward(
                        g, z, (hidden,), mu, rs, w.bfloat16(), b.bfloat16(),
                        [True, True, True]))
        with torch.no_grad():
            row["fwd_p0_ms"] = time_ms(
                lambda: fl.fused_residual_layernorm(x, y, w, b, EPS))
        if train:
            leaves = [t.clone().requires_grad_() for t in (x, y, w, b)]
            row["fwd_ms"] = time_ms(
                lambda: fl.fused_residual_layernorm(*leaves, EPS, DROPOUT_P,
                                                    gen))
            seed = _build.draw_seed(gen, x.device)
            with torch.no_grad():
                row["fwd_kernel_ms"] = time_ms(
                    lambda: fl._FusedResidualLayerNorm.apply(
                        x, y, w, b, seed, EPS, DROPOUT_P, True))
            out = fl.fused_residual_layernorm(*leaves, EPS, DROPOUT_P, gen)
            row["bwd_ms"] = time_ms(
                lambda: torch.autograd.grad(out, leaves, g,
                                            retain_graph=True))
        result["shapes"].append(row)
        print(json.dumps(row), flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of another commit")
    ap.add_argument("--trees", nargs="+", help="checkouts to time in turn")
    ap.add_argument("--out", help="write the runs here as JSON")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one or not (args.parent or args.trees):
        result = run_one()
        print(json.dumps(result), flush=True)
        if args.out:
            Path(args.out).write_text(json.dumps(result, indent=1))
        return
    runs = []
    if args.trees:
        trees = [Path(t).resolve() for t in args.trees]
    else:
        parent = Path(args.parent).resolve()
        trees = [parent, ROOT, ROOT, parent]
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=str(tree))
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one"],
            cwd=tree, env=env, capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit(f"layernorm_sweep: the run in {tree} failed")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(json.dumps(run), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(runs, indent=1))


if __name__ == "__main__":
    main()
