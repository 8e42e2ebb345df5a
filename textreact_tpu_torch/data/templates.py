"""Template table / preprocessed-label IO for template-based retrosynthesis
(own copy of textreact_tpu/data/templates.py, read through utils/table.py
instead of pandas).

Parity: reference textreact/tokenizer.py:291-295 (atom/bond template tables)
and dataset.py:199-204 (preprocessed_{split}.csv with Labels,
ProductAtomIdx2CanonIdx, ProductCanonBonds columns, parsed from python
literals).
"""

from __future__ import annotations

import ast
import os
from typing import Any, List, Tuple

from ..utils.table import read_csv


class TemplateTables:
    """Atom/bond template strings; class id = row position + 1 (class 0 is
    the 'no edit' background class everywhere)."""

    def __init__(self, atom_templates: List[str], bond_templates: List[str]):
        self.atom_templates = list(atom_templates)
        self.bond_templates = list(bond_templates)

    @property
    def num_atom_templates(self) -> int:
        return len(self.atom_templates)

    @property
    def num_bond_templates(self) -> int:
        return len(self.bond_templates)

    def atom_template(self, cls: int) -> str:
        return self.atom_templates[cls - 1]

    def bond_template(self, cls: int) -> str:
        return self.bond_templates[cls - 1]


def load_template_tables(template_path: str) -> TemplateTables:
    atom = read_csv(os.path.join(template_path, "atom_templates.csv"))["Template"]
    bond = read_csv(os.path.join(template_path, "bond_templates.csv"))["Template"]
    return TemplateTables(atom, bond)


def load_preprocessed_labels(template_path: str, split: str
                             ) -> Tuple[List[Any], List[Any], List[Any]]:
    table = read_csv(os.path.join(template_path, f"preprocessed_{split}.csv"))
    labels = [ast.literal_eval(v) for v in table["Labels"]]
    a2c = [ast.literal_eval(v) for v in table["ProductAtomIdx2CanonIdx"]]
    # ProductCanonBonds is a SET in the processor's CSV (reference
    # get_bonds_from_smiles returns a set; repr of an empty set is
    # 'set()', which literal_eval rejects) — normalize to a sorted list so
    # bond-pair slot order is deterministic across runs
    bonds = [sorted(ast.literal_eval(v)) if v != "set()" else []
             for v in table["ProductCanonBonds"]]
    return labels, a2c, bonds
