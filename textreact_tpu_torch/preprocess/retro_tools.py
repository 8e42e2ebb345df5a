"""USPTO-50K curation: canonicalization, corpus matching, year resplit (own
copy of textreact_tpu/preprocess/retro_tools.py over utils/table.py and the
port's chem kit; the port has no RDKit route, so canonicalization always
takes the own canonical writer).

Roles of reference preprocess/preprocess_retrosynthesis.py (canonical rxn
SMILES; match 50K reactions to the condition corpus by exact canonical
match, falling back to reaction-fingerprint similarity > 0.9) and
retro_year_split.py (resplit by patent year: <2012 train, 2012-13 valid,
2014+ test).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..chem import canonical_smiles
from ..chem.fingerprints import reaction_difference_fingerprint
from ..retrieval.fingerprints import count_tanimoto_similarities
from ..utils.table import Table, concat, isna


def canonical_rxn_smiles(rxn_smiles: str) -> Tuple[str, str, str, bool]:
    """Demap + canonicalize both sides (reference
    preprocess_retrosynthesis.py:19-30). Returns (rxn, reactants, products,
    success)."""
    parts = rxn_smiles.split(">")
    reactants, products = parts[0], parts[-1]
    try:
        cr = canonical_smiles(_strip_maps(reactants))
        cp = canonical_smiles(_strip_maps(products))
        return cr + ">>" + cp, cr, cp, True
    except Exception:
        return rxn_smiles, reactants, products, False


def _strip_maps(smiles: str) -> str:
    import re
    return re.sub(r"(?<=[^\[\]]):\d+(?=\])", "", smiles)


def reaction_similarity(rxn1: str, rxn2: str) -> float:
    """Count-Tanimoto over difference fingerprints (role of RDKit's
    TanimotoSimilarity on CreateDifferenceFingerprintForReaction outputs,
    preprocess_retrosynthesis.py:39-46)."""
    fp1 = reaction_difference_fingerprint(rxn1)
    fp2 = reaction_difference_fingerprint(rxn2)
    return float(count_tanimoto_similarities(fp1, fp2[None, :])[0])


def match_to_corpus(split_df: Table, corpus_df: Table,
                    split_name: str, sim_threshold: float = 0.9
                    ) -> Table:
    """Assign each retro reaction the id of its corpus reaction: exact
    canonical-rxn match (preferring same-patent ids), else the most similar
    same-patent reaction above threshold, else unk_{split}_{i}
    (reference preprocess_retrosynthesis.py:96-150)."""
    rxn_to_ids: Dict[str, List[str]] = {}
    for rid, rxn in zip(corpus_df["id"], corpus_df["canonical_rxn"]):
        rxn_to_ids.setdefault(rxn, []).append(rid)
    # the corpus rows of each source patent, in corpus order
    by_source: Dict[str, List[int]] = {}
    if "source" in corpus_df.columns:
        for pos, source in enumerate(corpus_df["source"]):
            if not isna(source):
                by_source.setdefault(source, []).append(pos)

    matched = []
    for i in range(len(split_df)):
        row = split_df.row(i)
        rxn = row["reactant_smiles"] + ">>" + row["product_smiles"]
        if rxn in rxn_to_ids:
            rxn_id = rxn_to_ids[rxn][0]
            for cand in rxn_to_ids[rxn]:
                if cand.startswith(str(row["id"])):
                    rxn_id = cand
                    break
        else:
            rxn_id = f"unk_{split_name}_{i}"
            rows = by_source.get(row["id"], [])
            if rows:
                sims = [reaction_similarity(rxn, corpus_df["canonical_rxn"][p])
                        for p in rows]
                best = int(np.argmax(sims))
                if sims[best] > sim_threshold:
                    rxn_id = corpus_df["id"][rows[best]]
        matched.append(rxn_id)
    out = split_df.copy()
    out["source"] = out["id"]
    out["id"] = matched
    return out


def year_resplit(dfs: List[Table], patent_year: Dict[str, int],
                 train_before: int = 2012, valid_years=(2012, 2013)
                 ) -> Tuple[Table, Table, Table]:
    """Re-partition matched splits by patent year
    (reference retro_year_split.py:17-36)."""
    df = concat(dfs)
    years = [patent_year.get(str(i).split("_")[0], -1) for i in df["id"]]
    train = df.take([y < train_before for y in years])
    valid = df.take([y in valid_years for y in years])
    test = df.take([y >= train_before and y not in valid_years for y in years])
    return train, valid, test
