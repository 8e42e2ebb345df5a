"""Brute-force similarity scan (sanity/debug path; twin of
textreact_tpu/retrieval/debug_cli.py, host only).

Role of reference retrieve/retrieve.py __main__: for the first N test
reactions, rank the whole train set by reaction-fingerprint Tanimoto
similarity and dump {idx: {rank, similarity}} json — a slow oracle used to
sanity-check the fast retriever.

Usage: python -m textreact_tpu_torch.retrieval.debug_cli --train_file ... \
           --test_file ... --output test_nn.json [--limit 100]
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np

from ..chem.fingerprints import reaction_difference_fingerprint
from ..utils.logging import log, setup_logging
from ..utils.table import read_csv
from .fingerprints import brute_force_rank, count_tanimoto_similarities


def main(argv: Optional[List[str]] = None) -> None:
    setup_logging()
    p = argparse.ArgumentParser(prog="textreact_tpu_torch.retrieval.debug_cli")
    p.add_argument("--train_file", required=True)
    p.add_argument("--test_file", required=True)
    p.add_argument("--field", default="canonical_rxn")
    p.add_argument("--output", required=True)
    p.add_argument("--limit", type=int, default=100)
    p.add_argument("--top", type=int, default=100)
    args = p.parse_args(argv)

    train_df = read_csv(args.train_file)
    test_df = read_csv(args.test_file)
    train_fps = np.stack([reaction_difference_fingerprint(s)
                          for s in train_df[args.field]])
    results = {}
    for i, smiles in enumerate(test_df[args.field]):
        if i >= args.limit:
            break
        sims = count_tanimoto_similarities(
            reaction_difference_fingerprint(smiles), train_fps)
        ranks, top_sims = brute_force_rank(sims, top=args.top)
        results[i] = {"rank": ranks, "similarity": top_sims}
        if (i + 1) % 10 == 0:
            log.info("scanned %d/%d", i + 1, min(args.limit, len(test_df)))
    with open(args.output, "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main()
