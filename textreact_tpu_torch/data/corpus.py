"""Corpus and neighbor-file IO (own copy of textreact_tpu/data/corpus.py,
reading CSVs through utils/table.py where that module uses pandas).

Parity: reference textreact/dataset.py:383-420 (read_corpus with pickle
cache, generate_train_label_corpus) and dataset.py:40-44 (nn json loading).
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from typing import Dict, List, Optional

from ..utils.table import read_csv

log = logging.getLogger(__name__)

CONDITION_COLS = ["catalyst1", "solvent1", "solvent2", "reagent1", "reagent2"]


def read_corpus(corpus_file: str, cache_path: Optional[str] = None) -> Dict[str, str]:
    """CSV (id, heading_text, paragraph_text) -> {id: 'heading. paragraph'}."""
    cache_file = None
    if cache_path:
        cache_file = os.path.join(cache_path, os.path.basename(corpus_file).replace(".csv", ".pkl"))
        if os.path.exists(cache_file):
            log.info("load corpus cache: %s", cache_file)
            with open(cache_file, "rb") as f:
                return pickle.load(f)
    corpus_df = read_csv(corpus_file)
    corpus: Dict[str, str] = {}
    for rxn_id, heading, para in zip(corpus_df["id"],
                                     corpus_df["heading_text"],
                                     corpus_df["paragraph_text"]):
        corpus[rxn_id] = f"{heading}. {para}" if len(heading) > 0 else para
    if cache_file:
        os.makedirs(os.path.dirname(cache_file) or ".", exist_ok=True)
        log.info("save corpus cache: %s", cache_file)
        with open(cache_file, "wb") as f:
            pickle.dump(corpus, f)
    return corpus


def generate_train_label_corpus(train_file: str) -> Dict[str, str]:
    """Train-label corpus: rxn SMILES with the gold condition string spliced
    between > > (reference dataset.py:406-420)."""
    train_df = read_csv(train_file)
    corpus: Dict[str, str] = {}
    for i in range(len(train_df)):
        row = train_df.row(i)
        condition = ""
        for col in CONDITION_COLS:
            val = row[col]
            if len(val) > 0:
                condition = val if condition == "" else condition + "." + val
        corpus[row["id"]] = row["canonical_rxn"].replace(">>", f">{condition}>")
    return corpus


def read_neighbors(nn_file: str) -> Dict[str, List[str]]:
    """Neighbor json [{'id': ..., 'nn': [...]}] -> {id: [neighbor ids]}."""
    with open(nn_file) as f:
        nn_data = json.load(f)
    return {ex["id"]: ex["nn"] for ex in nn_data}
