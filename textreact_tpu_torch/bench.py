"""Retrieval benchmark: exact top-20 L2 search on the card against a CPU
brute-force baseline (twin of the repo's root bench.py).

    python -m textreact_tpu_torch.bench [--device cpu]

The same shapes, data, parity check, CPU baseline and one-line JSON
contract as the JAX tool: N = 200,000 binary fingerprints of 1024 bits,
8192 queries, k = 20 on the card (20,000 x 256 and 128 queries with
`--device cpu`); BENCH_N and BENCH_M override N and the number of queries
(BENCH_N=700000 is the USPTO-condition-scale capture). The corpus, then the
queries, are drawn from numpy's default_rng(0).

1. `FlatIndex(corpus)` in the port's own default layout
   (retrieval/engine.py's rule: corpus-split), one warm search;
2. parity, before any timing: 64 queries equal to `numpy_reference_topk`,
   indices and distances, and the warm search's first 64 rows too;
3. end to end: the best of 3 rounds of 5 `search` calls, numpy in to numpy
   out, as queries/s;
4. on the card, device time: CUDA events around 4 calls of
   `ops.topk.exact_topk_l2` on the queries on the device, each call's
   queries rolled by one more row, the best of 3 (BENCH_DEVICE_ONLY=0 turns
   it off; an error in it fails the run);
5. the other layout's end-to-end and device times on an earlier line (its
   results equal the default layout's);
6. the CPU baseline: a numpy GEMM + argpartition over 64 queries, the best
   of 3; vs_baseline is queries/s over the baseline's.

The last line is ONE JSON object with the keys metric, value, unit and
vs_baseline; the unit names the device, the layout and the device-only
rate. Without a card and without `--device cpu` the run fails: nothing
falls back to the CPU. A failure, or the BENCH_TIMEOUT watchdog (default
1500 s), prints the line with value null and a `degraded` reason, and the
process exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from .models.factory import resolve_device
from .ops import topk
from .retrieval.engine import FlatIndex

METRIC = "retrieval_qps_exact_top20"
K = 20
# (N, d, queries) by device type
SHAPES = {"cuda": (200_000, 1024, 8192), "cpu": (20_000, 256, 128)}
REPS, ROUNDS = 5, 3          # end to end: best of ROUNDS rounds of REPS calls
DEVICE_CALLS = 4             # device time: best of ROUNDS rounds of these
PARITY_QUERIES = 64
BASELINE_QUERIES, BASELINE_ROUNDS = 64, 3
LAYOUTS = {True: "corpus-split", False: "query-outer"}


def make_data(n: int, d: int, m: int, seed: int = 0):
    """(corpus (n, d), queries (m, d)) int8 binary fingerprints: the corpus
    drawn first, then the queries, each bit set with probability 0.08."""
    rng = np.random.default_rng(seed)
    corpus = (rng.random((n, d)) < 0.08).astype(np.int8)
    queries = (rng.random((m, d)) < 0.08).astype(np.int8)
    return corpus, queries


def check_parity(index: FlatIndex, corpus: np.ndarray, queries: np.ndarray,
                 found, k: int = K) -> None:
    """The first PARITY_QUERIES queries searched alone, and the same rows of
    `found` (a search of all of them), equal the numpy oracle exactly."""
    sample = queries[:PARITY_QUERIES]
    ref_vals, ref_idx = topk.numpy_reference_topk(sample, corpus, k)
    got = [index.search(sample, k=k),
           (found[0][:len(sample)], found[1][:len(sample)])]
    for vals, idx in got:
        if not np.array_equal(idx, ref_idx):
            raise AssertionError("retrieval parity FAILED")
        if not np.array_equal(vals, ref_vals):
            raise AssertionError("distance parity FAILED")


def end_to_end(index: FlatIndex, queries: np.ndarray, k: int = K):
    """(queries/s, kernel launches per search): the best of ROUNDS rounds of
    REPS searches, numpy in to numpy out."""
    before = dict(topk.LAUNCHES)
    dt = float("inf")
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(REPS):
            index.search(queries, k=k)
        dt = min(dt, (time.perf_counter() - t0) / REPS)
    after = dict(topk.LAUNCHES)
    per_search = {LAYOUTS[name == "corpus_split"]:
                  (after[name] - before[name]) / (REPS * ROUNDS)
                  for name in after}
    return len(queries) / dt, per_search


def device_qps(index: FlatIndex, queries: np.ndarray, k: int = K) -> float:
    """Queries/s of the top-k kernel alone: CUDA events around DEVICE_CALLS
    calls on queries already on the card, the i-th call's rolled by i rows
    (copies made before the events), the best of ROUNDS."""
    q_dev = torch.from_numpy(topk.pad_matrix(queries, 1, 16)).to(index.device)
    rolled = [torch.roll(q_dev, i, 0) for i in range(1, DEVICE_CALLS + 1)]
    banned = torch.full((len(queries), 1), -1, dtype=torch.int32,
                        device=index.device)

    def call(q):
        return topk.exact_topk_l2(q, index.corpus, index.norms, banned, k=k,
                                  corpus_resident=index.corpus_resident)

    call(rolled[0])
    best = float("inf")
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for q in rolled:
            call(q)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / DEVICE_CALLS)
    return len(queries) / best


def cpu_baseline(corpus: np.ndarray, queries: np.ndarray, k: int = K
                 ) -> float:
    """Queries/s of an exact numpy scan (faiss-flat's GEMM + selection) over
    BASELINE_QUERIES queries, the best of BASELINE_ROUNDS."""
    qf = queries[:BASELINE_QUERIES].astype(np.float32)
    cf = corpus.astype(np.float32)
    cn = (cf * cf).sum(1)
    dt = float("inf")
    for _ in range(BASELINE_ROUNDS):
        t0 = time.perf_counter()
        d2 = (qf * qf).sum(1)[:, None] - 2.0 * (qf @ cf.T) + cn[None, :]
        part = np.argpartition(d2, k, axis=1)[:, :k]
        pv = np.take_along_axis(d2, part, axis=1)
        order = np.argsort(pv, axis=1, kind="stable")
        np.take_along_axis(part, order, axis=1)
        dt = min(dt, time.perf_counter() - t0)
    return len(qf) / dt


def measure(index: FlatIndex, queries: np.ndarray, device_time: bool
            ) -> dict:
    """One layout's queries/s end to end, kernel launches per search and
    (with `device_time`) device queries/s, else None."""
    qps, per_search = end_to_end(index, queries)
    return dict(qps=qps, launches_per_search=per_search,
                device_qps=device_qps(index, queries) if device_time
                else None)


def run(device=None) -> dict:
    """The whole benchmark; returns the JSON record (`record`) and what the
    earlier lines report: per layout its queries/s end to end, device
    queries/s (None on the CPU or with BENCH_DEVICE_ONLY=0) and kernel
    launches per search."""
    device = resolve_device(device)
    n, d, m = SHAPES[device.type]
    n = int(os.environ.get("BENCH_N", n))
    m = int(os.environ.get("BENCH_M", m))
    device_time = (device.type == "cuda"
                   and os.environ.get("BENCH_DEVICE_ONLY", "1") != "0")
    corpus, queries = make_data(n, d, m)
    index = FlatIndex(corpus, device=device)
    default = index.corpus_resident
    found = index.search(queries, k=K)                        # warm
    check_parity(index, corpus, queries, found)
    layouts = {LAYOUTS[default]: measure(index, queries, device_time)}
    del index
    other = FlatIndex(corpus, device=device, corpus_resident=not default)
    if not all(np.array_equal(a, b)
               for a, b in zip(other.search(queries, k=K), found)):
        raise AssertionError("the two layouts disagree")
    layouts[LAYOUTS[not default]] = measure(other, queries, device_time)
    del other
    cpu_qps = cpu_baseline(corpus, queries)
    main = layouts[LAYOUTS[default]]
    dev_note = (f", device-only {main['device_qps'] / 1e3:.1f}k qps"
                if main["device_qps"] else "")
    record = {
        "metric": METRIC,
        "value": round(main["qps"], 1),
        "unit": (f"queries/s (N={n}, d={d}, k={K}, {device.type} "
                 f"{LAYOUTS[default]}{dev_note})"),
        "vs_baseline": round(main["qps"] / cpu_qps, 2),
    }
    return dict(record=record, layouts=layouts, default=LAYOUTS[default],
                cpu_qps=cpu_qps, m=m)


def card_line(device: torch.device) -> str:
    """The card's name and power limit (nvidia-smi's), or the CPU."""
    if device.type != "cuda":
        return "device: cpu"
    line = torch.cuda.get_device_name(device)
    if shutil.which("nvidia-smi"):
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return f"device: {line}"


def report(result: dict, log=print) -> None:
    """The earlier lines: parity, each layout's numbers, the baseline."""
    log(f"parity: {PARITY_QUERIES} queries equal numpy_reference_topk "
        f"(indices and distances)")
    for name, lay in result["layouts"].items():
        dev = (f"{lay['device_qps'] / 1e3:.1f}k qps "
               f"({result['m'] / lay['device_qps'] * 1e3:.3f} ms a call)"
               if lay["device_qps"] else "not measured")
        log(f"layout {name}{' (default)' if name == result['default'] else ''}"
            f": end to end {lay['qps']:.1f} queries/s "
            f"({result['m'] / lay['qps'] * 1e3:.3f} ms a search), device-only "
            f"{dev}, kernel launches per search {lay['launches_per_search']}")
    log(f"cpu baseline: {result['cpu_qps']:.1f} queries/s "
        f"({BASELINE_QUERIES} queries, numpy GEMM + argpartition)")


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain top-k at the CPU shape)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(card_line(device), flush=True)
    result = run(device)
    report(result)
    print(json.dumps(result["record"]), flush=True)
    return 0


def _degraded(reason: str) -> str:
    return json.dumps({"metric": METRIC, "value": None, "unit": "queries/s",
                       "vs_baseline": None, "degraded": reason})


def _watchdog(timeout_s: int) -> None:
    """Print the degraded line and exit 1 if the run wedges."""
    import signal

    def on_alarm(signum, frame):
        print(_degraded(f"hang_watchdog_{timeout_s}s"), flush=True)
        os._exit(1)

    signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(timeout_s)


def _cli() -> int:
    _watchdog(int(os.environ.get("BENCH_TIMEOUT", 1500)))
    try:
        return main()
    except Exception as e:  # the line keeps its shape; the exit code fails
        import traceback
        traceback.print_exc()
        print(_degraded(f"runtime_failure: {type(e).__name__}"), flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(_cli())
