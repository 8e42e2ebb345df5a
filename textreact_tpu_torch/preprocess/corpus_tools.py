"""Corpus curation tools (own copy of textreact_tpu/preprocess/
corpus_tools.py over utils/table.py).

Roles of reference preprocess/dedup_corpus.py (dedup paragraphs by text and
map every reaction id to its canonical corpus id), gen_grant_corpus.py
(grant-patent-only corpus), and the download half of gen_uspto.py (USPTO
bulk-data fetch — network-gated; this framework consumes the resulting CSVs).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Tuple

from ..utils.table import Table


def dedup_corpus(corpus_df: Table) -> Tuple[Table, Dict[str, str]]:
    """Keep the first row per unique paragraph text; return the deduped
    corpus and {id -> canonical corpus id}
    (reference dedup_corpus.py:7-20)."""
    text_to_corpus_id: Dict[str, str] = {}
    id_to_corpus_id: Dict[str, str] = {}
    keep = []
    for idx, text in zip(corpus_df["id"], corpus_df["paragraph_text"]):
        if text not in text_to_corpus_id:
            text_to_corpus_id[text] = idx
            keep.append(True)
        else:
            keep.append(False)
        id_to_corpus_id[idx] = text_to_corpus_id[text]
    return corpus_df.take(keep), id_to_corpus_id


def add_corpus_id_column(df: Table, id_to_corpus_id: Dict[str, str]
                         ) -> Table:
    """Insert a corpus_id column right after id
    (reference dedup_corpus.py:24-45)."""
    df = df.copy()
    df["corpus_id"] = [id_to_corpus_id.get(i, i) for i in df["id"]]
    cols = ["id", "corpus_id"] + [c for c in df.columns
                                  if c not in ("id", "corpus_id")]
    return Table({c: df[c] for c in cols})


def grant_only_corpus(corpus_df: Table) -> Table:
    """Rows whose id does not mark an application patent
    (reference gen_grant_corpus.py: grants carry no 'A' doc-kind suffix in
    this corpus's id scheme)."""
    mask = [not str(i).split("_")[0].endswith("A") for i in corpus_df["id"]]
    return corpus_df.take(mask)


def download_uspto_bulk(years: Iterable[int], output_dir: str) -> None:
    """Fetch USPTO grant red-book archives (reference gen_uspto.py:24-60).
    Network-gated: raises in offline environments."""
    import re
    import urllib.request
    for year in years:
        url = f"https://bulkdata.uspto.gov/data/patent/grant/redbook/{year}/"
        content = urllib.request.urlopen(url).read().decode("utf-8")
        zips = re.findall(r"href=\"(I*\d{8}(?:\.ZIP|\.zip|\.tar))\"", content)
        path = os.path.join(output_dir, str(year))
        os.makedirs(path, exist_ok=True)
        for fname in zips:
            out = os.path.join(path, fname)
            if not os.path.exists(out):
                urllib.request.urlretrieve(url + fname, out)


def write_id_map(id_to_corpus_id: Dict[str, str], path: str) -> None:
    with open(path, "w") as f:
        json.dump(id_to_corpus_id, f)
