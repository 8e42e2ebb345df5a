"""Neural-retriever output conversion.

Role of reference retrieve/convert_format.py: a tevatron-style ranking jsonl
(one record per query with 'negative_passages' docids) becomes the {id, nn}
neighbor json the datasets consume.

Usage: python -m textreact_tpu_torch.retrieval.convert IN.jsonl OUT.json
"""

from __future__ import annotations

import json
import sys
from typing import List


def convert_tevatron_jsonl(in_path: str, out_path: str) -> int:
    records: List[dict] = []
    with open(in_path) as f:
        for line in f:
            if not line.strip():
                continue
            ex = json.loads(line)
            nn = [p["docid"] for p in ex["negative_passages"]]
            records.append({"id": ex["query_id"], "nn": nn})
    with open(out_path, "w") as f:
        json.dump(records, f)
    return len(records)


if __name__ == "__main__":
    n = convert_tevatron_jsonl(sys.argv[1], sys.argv[2])
    print(f"converted {n} records")
