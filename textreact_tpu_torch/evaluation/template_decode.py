"""Template application: predicted (edit site, template class) -> reactants
(twin of textreact_tpu/evaluation/template_decode.py over utils/table.py).

Role of reference textreact/template_decoder.py (get_pred_smiles_from_templates
-> RunReactants -> fix H/charge/chirality -> demap). Applying a retro
template requires SMARTS substructure matching and graph rewriting: the
port's own engine (chem/smarts.py + chem/reaction.py via
_own_template_apply) decodes with the reference's semantics, with or
without RDKit installed. The JAX package's RDKit twin of that engine
(_rdkit_template_apply) is not copied: no environment of the port has
RDKit to hold it against.

The template tables are keyed by their `Class` column, which pandas reads
as integers and the predicted classes are integers: `utils/table.py` infers
an all-digit column as ints the same way, so the lookups meet.
"""

from __future__ import annotations

import ast
import os
from typing import Any, Dict, List

from ..utils.table import Table, read_csv
from ._own_template_apply import apply_ranked_edits as _apply_ranked_edits

_PRODUCTS_PER_WORKER = 16


def load_template_infos(template_path: str) -> Dict[str, Dict]:
    table = read_csv(os.path.join(template_path, "template_infos.csv"))
    return {row["Template"]: {
        "edit_site": ast.literal_eval(row["edit_site"]),
        "change_H": ast.literal_eval(row["change_H"]),
        "change_C": ast.literal_eval(row["change_C"]),
        "change_S": ast.literal_eval(row["change_S"]),
    } for row in map(table.row, range(len(table)))}


def decode_template_predictions(prediction: Dict[int, Dict[str, Any]],
                                data_df: Table, template_path: str,
                                top_k: int, num_workers: int = 0
                                ) -> List[List[str]]:
    """Per-example list of decoded reactant SMILES (reference
    evaluate.py:47-64)."""
    atom_df = read_csv(os.path.join(template_path, "atom_templates.csv"))
    bond_df = read_csv(os.path.join(template_path, "bond_templates.csv"))
    atom_templates = dict(zip(atom_df["Class"], atom_df["Template"]))
    bond_templates = dict(zip(bond_df["Class"], bond_df["Template"]))
    template_infos = load_template_infos(template_path)

    args = []
    for i in range(len(data_df)):
        pred = prediction[i]
        pred_prob = [(*p, s) for p, s in zip(pred["prediction"], pred["score"])]
        args.append((pred_prob, data_df["product_smiles"][i]))

    # a spawned worker takes seconds to import the package, a product's
    # decode a fraction of one: a worker gets at least _PRODUCTS_PER_WORKER
    workers = min(num_workers, len(args) // _PRODUCTS_PER_WORKER)
    if workers > 1:
        # spawned, not forked: the caller holds threads (the loader's, the
        # CUDA runtime's) that a fork would copy mid-flight
        import multiprocessing
        from functools import partial
        fn = partial(_decode_one_star, atom_templates=atom_templates,
                     bond_templates=bond_templates,
                     template_infos=template_infos, top_k=top_k)
        with multiprocessing.get_context("spawn").Pool(workers) as p:
            return p.map(fn, args)
    return [_decode_one(pp, prod, atom_templates, bond_templates,
                        template_infos, top_k) for pp, prod in args]


def _decode_one_star(arg, **kw):
    return _decode_one(*arg, **kw)


def _decode_one(template_preds, product, atom_templates, bond_templates,
                template_infos, top_k) -> List[str]:
    """Apply ranked edits until top_k distinct valid reactant sets are found
    (reference template_decoder.py:20-37)."""
    return _apply_ranked_edits(template_preds, product, atom_templates,
                               bond_templates, template_infos, top_k)
