"""Retrosynthesis metric: top-k canonical-SMILES match rank (twin of
textreact_tpu/evaluation/retro.py over utils/table.py).

Bit-faithful port target: reference textreact/evaluate.py:27-71
(canonical_smiles / _compare_pred_and_gold / evaluate_retrosynthesis):
canonicalize gold reactants, canonicalize each beam prediction, rank of the
first exact string match; top-k accuracy for k in {1,2,3,5,10,20}.

Canonicalization goes through RDKit when it is importable (rdkit_bridge),
else through the C++ accelerator (chem/native.py; a beam's list in one
call), or through the pure-Python canonicalizer (chem/canon.py) when the
caller passes `native=False`. The last two give the same strings.
"""

from __future__ import annotations

import multiprocessing
from typing import Any, Dict, List, Optional, Sequence

from ..chem import canonical_smiles
from ..chem.rdkit_bridge import HAS_RDKIT, rdkit_canonical_smiles
from ..utils.table import Table

TOP_KS = (1, 2, 3, 5, 10, 20)
NO_MATCH = 100000


def _canon(smiles: str, native: bool = True) -> str:
    if HAS_RDKIT:
        return rdkit_canonical_smiles(smiles)
    if native:
        from ..chem.native import native_canonical_smiles
        return native_canonical_smiles(smiles)
    return canonical_smiles(smiles)


def compare_pred_and_gold(pred: Sequence[str], gold: str,
                          native: bool = True) -> int:
    """Rank (0-based) of the first prediction whose canonical form equals
    the canonical gold; NO_MATCH if none (reference evaluate.py:35-40)."""
    if native and not HAS_RDKIT:
        from ..chem.native import native_canonical_batch
        canon = native_canonical_batch(list(pred))
    else:
        canon = (_canon(s, native) for s in pred)
    for i, smiles in enumerate(canon):
        if smiles == gold:
            return i
    return NO_MATCH


def evaluate_retrosynthesis(prediction: Dict[int, Dict[str, Any]],
                            data_df: Table, top_k: int,
                            template_based: bool = False,
                            template_path: Optional[str] = None,
                            num_workers: int = 0) -> Dict[int, float]:
    num_example = len(data_df)
    golds = list(data_df["reactant_smiles"])
    if num_workers > 1:
        with multiprocessing.Pool(num_workers) as p:
            gold_list = p.map(_canon, golds)
    else:
        gold_list = [_canon(g) for g in golds]

    if template_based:
        from .template_decode import decode_template_predictions
        pred_list = decode_template_predictions(
            prediction, data_df, template_path, top_k, num_workers=num_workers)
    else:
        pred_list = [prediction[i]["prediction"] for i in range(num_example)]

    # per-example prediction canonicalization + compare is the slow link at
    # USPTO-50K scale (num_beams x N strings): pooled like the reference
    # (evaluate.py:67, p.starmap(_compare_pred_and_gold, ...))
    if num_workers > 1:
        with multiprocessing.Pool(num_workers) as p:
            indices: List[int] = p.starmap(
                compare_pred_and_gold, zip(pred_list, gold_list),
                chunksize=max(1, num_example // (num_workers * 4)))
    else:
        indices = [compare_pred_and_gold(p, g)
                   for p, g in zip(pred_list, gold_list)]
    return {x: sum(i < x for i in indices) / num_example for x in TOP_KS}
