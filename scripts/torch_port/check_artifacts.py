"""One-command validator for the external-parity-day artifacts, for the
PyTorch port (twin of scripts/check_artifacts.py).

It checks, in place, everything `scripts/torch_port/parity_run.py` will
consume (existence, schema, referential integrity) and prints a
ready/not-ready report with the port's follow-up command per leg. CSVs are
read with textreact_tpu_torch/utils/table.py, not pandas. The RDKit halves
are gated in the port (no RDKit engine), so its goldens leg is never ready.

    python scripts/torch_port/check_artifacts.py --recipe RCR \
        --data_path data/RCR --corpus_file data/USPTO_rxn_corpus.csv \
        [--nn_path data/Tevatron_output/RCR] \
        [--scibert data/scibert_scivocab_uncased]
    python scripts/torch_port/check_artifacts.py --recipe goldens

Exit 0 iff the queried leg is ready to run.

Schemas below are the reference's exact consumption contract:
- condition CSVs: reference textreact/dataset.py:18,29,190 ('id',
  'canonical_rxn', catalyst1/solvent1/solvent2/reagent1/reagent2).
- retro CSVs: dataset.py:227,283 ('id', 'product_smiles',
  'reactant_smiles').
- corpus CSV: dataset.py:383-403 ('id', 'heading_text', 'paragraph_text').
- neighbor files: retrieve_faiss.py:116-130 (list of {'id', 'nn': [ids]});
  tevatron output must first pass through retrieve/convert_format.py.
- SciBERT: HF checkpoint dir (config.json + vocab.txt + weights) — the
  reference passes 'allenai/scibert_scivocab_uncased' (train_RCR.sh:14).
- time splits add a 'year' column (retrieve_faiss.py:102-103 '--before').
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from textreact_tpu_torch.utils.table import isna, read_csv  # noqa: E402

CONDITION_COLS = ["catalyst1", "solvent1", "solvent2", "reagent1", "reagent2"]
SPLIT_COLS = {
    "condition": ["id", "canonical_rxn"] + CONDITION_COLS,
    "retro": ["id", "product_smiles", "reactant_smiles"],
}
CORPUS_COLS = ["id", "heading_text", "paragraph_text"]
SCIBERT_FILES = ["config.json", "vocab.txt"]
SCIBERT_WEIGHTS = ["pytorch_model.bin", "model.safetensors", "flax_model.msgpack"]

_REPORT: list = []


def _check(ok: bool, what: str, detail: str = "") -> bool:
    _REPORT.append((bool(ok), what, detail))
    return bool(ok)


def check_csv(path: str, cols: list, name: str, min_rows: int = 1) -> "object":
    if not _check(os.path.isfile(path), f"{name} exists", path):
        return None
    try:
        df = read_csv(path).head(200_000)
    except Exception as e:
        _check(False, f"{name} parses as CSV", f"{type(e).__name__}: {e}")
        return None
    missing = [c for c in cols if c not in df.columns]
    _check(not missing, f"{name} has columns {cols}",
           f"missing {missing}; has {list(df.columns)[:12]}" if missing else
           f"{len(df)} rows (first 200k)")
    if _check(len(df) >= min_rows, f"{name} non-empty", f"{len(df)} rows"):
        ids = df["id"] if "id" in df.columns else None
        if ids is not None:
            dups = len(ids) - len(set(ids))
            _check(not any(isna(i) for i in ids) and not dups,
                   f"{name} ids unique & non-null",
                   f"{dups} dups" if dups else "")
    return df


def check_nn_file(path: str, name: str, split_ids, train_ids) -> None:
    if not _check(os.path.isfile(path), f"{name} exists", path):
        return
    try:
        with open(path) as f:
            data = json.load(f)
    except Exception as e:
        _check(False, f"{name} parses as JSON", f"{type(e).__name__}: {e}")
        return
    ok_shape = (isinstance(data, list) and data
                and all(isinstance(r, dict) and "id" in r and "nn" in r
                        and isinstance(r["nn"], list) for r in data[:100]))
    if not _check(ok_shape, f"{name} is [{{'id', 'nn': [...]}}]",
                  "tevatron *_rank.json must first pass through the format "
                  "converter (reference retrieve/convert_format.py; ours: "
                  "python -m textreact_tpu_torch.retrieval.convert)"):
        return
    by_id = {r["id"] for r in data}
    if split_ids is not None:
        missing = [i for i in list(split_ids)[:1000] if i not in by_id]
        _check(not missing, f"{name} covers the split's ids",
               f"{len(missing)}/1000 sampled split ids missing, e.g. "
               f"{missing[:3]}" if missing else f"{len(by_id)} entries")
    if train_ids is not None:
        sample = [i for r in data[:50] for i in r["nn"][:5]]
        bad = [i for i in sample if i not in train_ids]
        _check(not bad, f"{name} neighbor ids resolve in the corpus/train set",
               f"e.g. {bad[:3]}" if bad else f"sampled {len(sample)} ok")


def check_recipe(args) -> None:
    task = "condition" if args.recipe == "RCR" else "retro"
    cols = list(SPLIT_COLS[task])
    if args.time_split:
        cols.append("year")
    dfs = {}
    for split, fname in (("train", args.train_file), ("valid", args.valid_file),
                         ("test", args.test_file)):
        dfs[split] = check_csv(os.path.join(args.data_path, fname), cols,
                               f"{split} CSV")

    corpus_ids = None
    if args.corpus_file:
        cdf = check_csv(args.corpus_file, CORPUS_COLS, "corpus CSV")
        corpus_ids = set(cdf["id"]) if cdf is not None else None

    if args.nn_path:
        train_like = corpus_ids
        if train_like is None and dfs.get("train") is not None:
            train_like = set(dfs["train"]["id"])
        for split, base in (("train", "train"), ("valid", "val"),
                            ("test", "test")):
            ids = dfs[split]["id"] if dfs.get(split) is not None else None
            check_nn_file(os.path.join(args.nn_path,
                                       f"{args.nn_prefix}{base}.json"),
                          f"{split} nn file", ids, train_like)
    else:
        _REPORT.append((True, "nn files: none given",
                        "parity_run.py will build fingerprint+index "
                        "neighbors itself (reference retrieve_faiss.py)"))

    if args.scibert:
        for f in SCIBERT_FILES:
            _check(os.path.isfile(os.path.join(args.scibert, f)),
                   f"scibert/{f} exists", args.scibert)
        _check(any(os.path.isfile(os.path.join(args.scibert, w))
                   for w in SCIBERT_WEIGHTS),
               f"scibert weights exist ({'|'.join(SCIBERT_WEIGHTS)})",
               args.scibert)
        vocab = os.path.join(args.scibert, "vocab.txt")
        if os.path.isfile(vocab):
            with open(vocab) as f:
                n = sum(1 for _ in f)
            _check(n > 10_000, "scibert vocab plausibly sized", f"{n} tokens")
    else:
        _REPORT.append((True, "scibert: none given",
                        "encoder trains from scratch; pass --scibert for the "
                        "reference recipe (train_RCR.sh:14)"))

    follow = ("python scripts/torch_port/parity_run.py "
              f"--recipe {args.recipe} "
              f"--data_path {args.data_path}"
              + (f" --corpus_file {args.corpus_file}" if args.corpus_file else "")
              + (f" --nn_path {args.nn_path}" if args.nn_path else "")
              + (f" --scibert {args.scibert}" if args.scibert else "")
              + f" --save_path output/parity_{args.recipe}")
    report_and_exit(follow)


def check_goldens() -> None:
    _check(False, "RDKit halves in the port",
           "gated: textreact_tpu_torch has no RDKit engine, so the "
           "byte-parity goldens run on the JAX package only")
    report_and_exit("python scripts/check_artifacts.py --recipe goldens")


def report_and_exit(follow_up: str) -> None:
    ok = all(r[0] for r in _REPORT)
    for good, what, detail in _REPORT:
        print(f"  [{'ok' if good else 'MISSING'}] {what}"
              + (f" — {detail}" if detail else ""))
    print(f"\n{'READY' if ok else 'NOT READY'}. Next: {follow_up}")
    sys.exit(0 if ok else 1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--recipe", required=True,
                   choices=["RCR", "RetroSyn_tf", "RetroSyn_tb", "goldens"])
    p.add_argument("--data_path")
    p.add_argument("--train_file", default="train.csv")
    p.add_argument("--valid_file", default="val.csv")
    p.add_argument("--test_file", default="test.csv")
    p.add_argument("--corpus_file", default=None)
    p.add_argument("--nn_path", default=None)
    p.add_argument("--nn_prefix", default="")
    p.add_argument("--scibert", default=None)
    p.add_argument("--time_split", action="store_true",
                   help="require the 'year' column (TS recipes)")
    args = p.parse_args(argv)
    if args.recipe == "goldens":
        check_goldens()
    else:
        if not args.data_path:
            p.error("--data_path is required for training recipes")
        check_recipe(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
