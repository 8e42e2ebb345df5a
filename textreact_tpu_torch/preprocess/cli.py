"""Curation pipeline command line (own copy of textreact_tpu/preprocess/cli.py:
the same subcommands, arguments and output files, read and written through
utils/table.py; nothing runs on a device).

Orchestrates the downstream USPTO-Condition stages (roles of reference
preprocess/uspto_script 3.0-5.0 + dedup_corpus.py) from an extracted
conditions CSV:

  condition-split: frequency filter + excess removal + slot split + random
                   no-overlap split (+ time split with --patent_info) +
                   condition vocab file.
  dedup-corpus:    paragraph dedup + id->corpus_id map.

Usage:
  python -m textreact_tpu_torch.preprocess.cli condition-split \\
      --input conditions.csv --output_path out/ [--patent_info info.json]
  python -m textreact_tpu_torch.preprocess.cli dedup-corpus \\
      --input corpus.csv --output_path out/
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from ..utils.logging import log, setup_logging
from ..utils.table import read_csv
from .condition_extraction import (filter_and_split_conditions, merge_and_dedup,
                                   split_condition_slots)
from .condition_splits import (condition_vocab, random_split_no_overlap,
                               time_split, write_vocab)
from .corpus_tools import dedup_corpus, write_id_map


def cmd_condition_split(args) -> None:
    os.makedirs(args.output_path, exist_ok=True)
    db = read_csv(args.input)
    db, freqs = merge_and_dedup([db])
    for role, df in freqs.items():
        df.to_csv(os.path.join(args.output_path, f"{role}_freq.csv"))
    db = filter_and_split_conditions(db, freqs,
                                     remove_threshold=args.remove_threshold)
    db = split_condition_slots(db)
    split = random_split_no_overlap(db, seed=args.seed)
    split.to_csv(os.path.join(args.output_path, "USPTO_condition.csv"))
    for name in ("train", "val", "test"):
        part = split.take([d == name for d in split["dataset"]])
        part.to_csv(os.path.join(args.output_path, f"{name}.csv"))
        log.info("%s: %d rows", name, len(part))
    write_vocab(condition_vocab(split),
                os.path.join(args.output_path, "vocab_condition.txt"))
    if args.patent_info:
        with open(args.patent_info) as f:
            info = json.load(f)
        years = {k: v["year"] if isinstance(v, dict) else v
                 for k, v in info.items()}
        tr, va, te = time_split(split, years)
        year_dir = os.path.join(args.output_path, "year_split")
        os.makedirs(year_dir, exist_ok=True)
        tr.to_csv(os.path.join(year_dir, "USPTO_condition_train.csv"))
        va.to_csv(os.path.join(year_dir, "USPTO_condition_val.csv"))
        te.to_csv(os.path.join(year_dir, "USPTO_condition_test.csv"))
        log.info("time split: %d/%d/%d", len(tr), len(va), len(te))


def cmd_dedup_corpus(args) -> None:
    os.makedirs(args.output_path, exist_ok=True)
    corpus = read_csv(args.input)
    dedup, id_map = dedup_corpus(corpus)
    dedup.to_csv(os.path.join(args.output_path, "corpus_dedup.csv"))
    write_id_map(id_map, os.path.join(args.output_path, "id_to_corpus_id.json"))
    log.info("corpus: %d -> %d unique paragraphs", len(corpus), len(dedup))


def main(argv: Optional[List[str]] = None) -> None:
    setup_logging()
    p = argparse.ArgumentParser(prog="textreact_tpu_torch.preprocess")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("condition-split")
    sp.add_argument("--input", required=True)
    sp.add_argument("--output_path", required=True)
    sp.add_argument("--patent_info", default=None)
    sp.add_argument("--remove_threshold", type=int, default=100)
    sp.add_argument("--seed", type=int, default=123)
    sp.set_defaults(fn=cmd_condition_split)

    sp = sub.add_parser("dedup-corpus")
    sp.add_argument("--input", required=True)
    sp.add_argument("--output_path", required=True)
    sp.set_defaults(fn=cmd_dedup_corpus)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
