"""The readings a cell's limits are set from (`portbench/limits/<cell>.json`),
on the card at the cell's own size, many seeds in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--out FILE]

For every seed, from the same set-up as a run (`portbench/run.py`):
- `program`: the numbers of `check.py` for what the program produced;
- `control`: the same numbers for the reference computed with float8
  products in the program's place (training: its first steps; serving: its
  scores of the served tokens and its choice at the last step);
- the faults a cell can have, planted in the reference put in the
  program's place or in the served answers: training `half_batch` (every
  micro-batch's first half of rows, the mean over them); serving
  `token` (the best served live beam's last token changed).
A training state left unchanged reads 1 by `update_gap` and needs no run.
Each seed's readings are one JSON line, on standard output and in FILE.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import check, run  # noqa: E402


def train_readings(ctx, runner) -> dict:
    import torch
    cell = runner.Cell(ctx)
    cell.free()
    gc.collect()
    torch.cuda.empty_cache()
    f32 = runner.run_reference(ctx, cell.pool, cell._weights(torch.float32),
                               "f32")
    out = {"program": {k: v[0] for k, v in cell.compare(f32).items()}}
    for name, kw in (("control", {"precision": "fp8"}),
                     ("half_batch", {"precision": "f32",
                                     "half_batch": True})):
        low = runner.run_reference(ctx, cell.pool,
                                   cell._weights(torch.float32), **kw)
        out[name] = {k: v[0] for k, v in check.train_numbers(
            low["losses"], f32["losses"], low["grad_norms"],
            f32["grad_norms"], low["delta_norms"],
            f32["delta_norms"]).items()}
    return out


def serve_readings(ctx, runner, batches: int) -> dict:
    import torch
    cell = runner.Cell(ctx)
    for _ in range(batches):
        cell.run_unit()
    cell.sync()
    cell.free()
    gc.collect()
    torch.cuda.empty_cache()
    sample = cell.sample()
    params = cell._weights(torch.float32)
    detail = {"program": [], "control": []}
    out = {"program": runner.serve_numbers(ctx, cell.pool, sample, params,
                                           detail=detail["program"]),
           "control": runner.serve_numbers(ctx, cell.pool, sample, params,
                                           control=True,
                                           detail=detail["control"])}
    eos = ctx.cfg["decoder_ids"]["eos"]
    V = ctx.cfg["decoder"]["vocab_size"]
    altered = []
    for i, r, seqs, scores, steps in sample:
        seqs = seqs.copy()
        live = [k for k in range(seqs.shape[0])
                if check.served_end(seqs[k], steps, eos) == steps
                and seqs[k, steps] != eos]
        k = live[0] if live else 0
        t = check.served_end(seqs[k], steps, eos)
        tok = seqs[k, t]
        new = (tok + 1) % V
        seqs[k, t] = new if new != eos else (new + 1) % V
        altered.append((i, r, seqs, scores, steps))
    out["token"] = runner.serve_numbers(ctx, cell.pool, altered, params)
    out["detail"] = detail
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--batches", type=int, default=2,
                    help="serving: batches served after the warm-up")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import importlib
    bench = run.load_benchmark()
    cell_spec = run.find(bench["workloads"], args.workload, "workload")
    config = run.find(bench["configs"], cell_spec["config"], "configuration")
    device = run.chip_device(cell_spec["chips"])
    from portbench import program
    program.build_kernels()
    run.log(f"card: {run.power_limit()}")
    sink = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ns = argparse.Namespace(seed=seed)
        ctx = run.Context(ns, cell_spec, config, device)
        runner = importlib.import_module(f"portbench.kinds.{ctx.mix['kind']}")
        if ctx.mix["kind"] == "train":
            readings = train_readings(ctx, runner)
        else:
            readings = serve_readings(ctx, runner, args.batches)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "seconds": time.perf_counter() - t0, **readings})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        gc.collect()
    if run.forbidden_modules():
        raise SystemExit(f"JAX modules loaded: {run.forbidden_modules()}")


if __name__ == "__main__":
    main()
