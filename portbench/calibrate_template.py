"""The readings the limits of a template training cell are set from
(`portbench/limits/<cell>.json`), on the card at the cell's own size, many
seeds in one process.

    python3 portbench/calibrate_template.py --workload retro_tb.train \
        --seeds 1,2,3 [--out FILE]

For every seed, `calibrate.train_readings` (the program, the float8
control and the half-batch fault, with the reference put in the
program's place) and the fault of this mechanism: `mask_dropped`, the
reference under the (B, L) mask of its real keys in the program's place,
held against the reference under the bond mask. A state left
unchanged reads 1 by `update_gap` and needs no run. Each seed's readings
are one JSON line, on standard output and in FILE. The benchmark's own runs
never run this.
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

from portbench import calibrate, check, run  # noqa: E402
from portbench.kinds import train_template  # noqa: E402


class Recorder:
    """The kind, with the pool and the float32 reference of its last
    `run_reference` kept, which the fault of this mechanism is held
    against."""

    Cell = train_template.Cell

    def __init__(self):
        self.pool = self.f32 = None

    def run_reference(self, ctx, pool, params, precision, **kw):
        ref = train_template.run_reference(ctx, pool, params, precision,
                                           **kw)
        if precision == "f32" and not kw:
            self.pool, self.f32 = pool, ref
        return ref


def readings(ctx) -> dict:
    import torch
    from portbench import weights
    rec = Recorder()
    out = calibrate.train_readings(ctx, rec)
    params = weights.make(train_template.specs(ctx.cfg), ctx.seed,
                          ctx.cfg["encoder"]["initializer_range"],
                          torch.float32, ctx.device)
    low = train_template.run_reference(ctx, rec.pool, params, "f32",
                                       key_mask=True)
    ref = rec.f32
    out["mask_dropped"] = {k: v[0] for k, v in check.train_numbers(
        low["losses"], ref["losses"], low["grad_norms"], ref["grad_norms"],
        low["delta_norms"], ref["delta_norms"]).items()}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
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
        ctx = run.Context(argparse.Namespace(seed=seed), cell_spec, config,
                          device)
        found = readings(ctx)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "seconds": time.perf_counter() - t0, **found})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        gc.collect()
    if run.forbidden_modules():
        raise SystemExit(f"JAX modules loaded: {run.forbidden_modules()}")


if __name__ == "__main__":
    main()
