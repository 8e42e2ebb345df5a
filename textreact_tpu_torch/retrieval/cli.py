"""Retrieval CLI: build the index on the GPU and write neighbor files
(twin of textreact_tpu/retrieval/cli.py).

Mirrors reference retrieve/retrieve_faiss.py end to end: fingerprint
train/val/test CSVs, cache train fingerprints, exact top-20 search of the
train corpus (train queries itself — self-neighbors are handled downstream
by the predictor's gold-neighbor logic, reference dataset.py:62-66), write
{id, nn} JSON per split, and print the raw-retrieval condition-match
report (retrieve_faiss.py:132-144). `--before` filters the train corpus by
year for the time split (retrieve_faiss.py:102-103). The CSVs are read by
utils/table.py, which repeats pandas' type inference where it shows in the
outputs. `--device` names the device (default: the CUDA card; the command
fails without one). `--shard_corpus` cuts the corpus into one shard per
visible card (`FlatIndex(devices=...)`); with `--device cpu` into two CPU
shards, a rehearsal of the sharded path.

Usage: python -m textreact_tpu_torch.retrieval.cli --data_path ... --train_file ...
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..models.factory import resolve_device
from ..ops.topk import MAX_K
from ..utils.logging import log, setup_logging
from ..utils.table import read_csv
from .engine import FlatIndex
from .fingerprints import molecule_fingerprints, reaction_fingerprints

CONDITION_COLS = ["catalyst1", "solvent1", "solvent2", "reagent1", "reagent2"]


def get_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(prog="textreact_tpu_torch.retrieval")
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--train_file", type=str, required=True)
    p.add_argument("--valid_file", type=str, required=True)
    p.add_argument("--test_file", type=str, required=True)
    p.add_argument("--field", type=str, default="canonical_rxn")
    p.add_argument("--before", type=int, default=-1)
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--k", type=int, default=20,
                   help=f"neighbours per query, 1..{MAX_K} (the top-k kernels "
                        f"keep each query's list in shared memory)")
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--check_parity", action="store_true",
                   help="verify kernel results against the numpy oracle")
    p.add_argument("--shard_corpus", action="store_true",
                   help="shard the corpus over every visible card (two "
                        "shards with --device cpu)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if not 1 <= args.k <= MAX_K:
        p.error(f"--k {args.k} outside 1..{MAX_K}: the top-k kernels keep "
                f"each query's list in shared memory")
    return args


def fingerprint_fn(field: str, num_workers: int):
    if field == "canonical_rxn":
        log.info("reaction fingerprints")
        return lambda smiles: reaction_fingerprints(smiles, num_workers=num_workers)
    log.info("molecule (Morgan) fingerprints")
    return lambda smiles: molecule_fingerprints(smiles, num_workers=num_workers)


def compare_condition(row1, row2) -> bool:
    """All five condition slots equal, NaN-tolerant
    (reference retrieve_faiss.py:53-59)."""
    for field in CONDITION_COLS:
        a, b = row1[field], row2[field]
        if not isinstance(a, str) and not isinstance(b, str):
            continue
        if a != b:
            return False
    return True


def write_neighbors(path: str, query_ids, rank: np.ndarray, train_ids) -> None:
    # when k exceeds the candidate count the engine pads ranks with the BIG
    # sentinel (faiss pads with -1, retrieve_faiss.py:65-71) — drop them
    n_train = len(train_ids)
    result = [{"id": qid, "nn": [train_ids[n] for n in nn if 0 <= n < n_train]}
              for qid, nn in zip(query_ids, rank.tolist())]
    with open(path, "w") as f:
        json.dump(result, f)


def main(argv: Optional[List[str]] = None) -> None:
    setup_logging()
    args = get_args(argv)
    os.makedirs(args.output_path, exist_ok=True)

    train_df = read_csv(os.path.join(args.data_path, args.train_file))
    val_df = read_csv(os.path.join(args.data_path, args.valid_file))
    test_df = read_csv(os.path.join(args.data_path, args.test_file))
    if args.before != -1:
        train_df = train_df.take([y < args.before for y in train_df["year"]])

    fp_fn = fingerprint_fn(args.field, args.num_workers)
    fp_cache = os.path.join(args.output_path, "train_fp.npy")
    if os.path.exists(fp_cache):
        train_fps = np.load(fp_cache)
        log.info("loaded train fingerprints: %s", train_fps.shape)
    else:
        t0 = time.time()
        train_fps = fp_fn(list(train_df[args.field]))
        log.info("fingerprinted %d train rows in %.1fs", len(train_fps),
                 time.time() - t0)
        np.save(fp_cache, train_fps)

    devices = None
    if args.shard_corpus:
        device = resolve_device(args.device)
        devices = ([device, device] if device.type == "cpu" else
                   [f"cuda:{i}" for i in range(torch.cuda.device_count())])
        log.info("corpus sharded over %d devices", len(devices))
    index = FlatIndex(train_fps, device=args.device, devices=devices)
    log.info("flat index over %s on %s", train_fps.shape, index.device)
    train_ids = list(train_df["id"])

    rank = None
    for split, df, out_name in (("train", train_df, "train.json"),
                                ("val", val_df, "val.json"),
                                ("test", test_df, "test.json")):
        if split == "train":
            query_fps = train_fps
        else:
            query_fps = fp_fn(list(df[args.field]))
        t0 = time.time()
        _, rank = index.search(query_fps, k=args.k)
        log.info("%s search: %d queries in %.2fs", split, len(query_fps),
                 time.time() - t0)
        if args.check_parity:
            _, ref = index.reference_search(query_fps[:256], k=args.k)
            assert np.array_equal(rank[:256], ref), f"parity failure on {split}"
            log.info("%s parity check passed", split)
        write_neighbors(os.path.join(args.output_path, out_name),
                        list(df["id"]), rank, train_ids)

    # raw retrieval quality report (condition task only)
    if args.field == "canonical_rxn" and rank is not None:
        cnt = {x: 0 for x in (1, 3, 5, 10, 15)}
        for i, nn in enumerate(rank):
            test_row = test_df.row(i)
            hit_map = [compare_condition(test_row, train_df.row(n)) for n in nn]
            for x in cnt:
                cnt[x] += bool(np.any(hit_map[:x]))
        print(cnt, len(test_df))
        print("  ".join(f"Top-{x}: {cnt[x] / len(test_df):.4f}" for x in cnt))


if __name__ == "__main__":
    main()
