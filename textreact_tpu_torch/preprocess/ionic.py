"""Ionic-compound reagent splitting + formal-charge filtering (own copy of
textreact_tpu/preprocess/ionic.py, over the port's chem kit and its copy of
the asset table).

Role of reference preprocess/uspto_script/3.0.split_condition_and_slect.py:41-130
with preprocess/uspto_script/utils.py (MolRemover:53-97, get_mol_charge:163-191,
mol_charge_class:46-50): each reagent combination is stripped of known ionic
compounds (a curated table of ~78 salt/complex patterns, vendored at
assets/reagent_ionic_compounds.txt), the remaining fragments are classified by
formal charge, charged leftovers ("unknown") are dropped from the reagent list,
and a row survives only if anything known remains.

Representation difference (documented, not a behavior gap for this data): the
reference deletes the salt patterns as RDKit substructures
(SaltRemover/DeleteSubstructs); every table entry is a complete standalone-ion
combination ([Na+].[OH-], LiAlH4, ...), so on '.'-separated reagent lists the
deletion reduces to canonical fragment-multiset removal, which is what the own
chem kit implements here.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import List, Optional, Sequence, Tuple

from ..chem import canonical_smiles

MOL_CHARGE_CLASS = ("Positive", "Negative", "Neutral")  # utils.py:46-50

_DEFAULT_TABLE = os.path.join(os.path.dirname(__file__), "..", "assets",
                              "reagent_ionic_compounds.txt")


def mol_charge(smiles: str) -> Tuple[str, bool]:
    """Classify one fragment by formal charges (reference get_mol_charge,
    utils.py:163-191). Returns (class, neutralization) where neutralization
    is True iff the fragment holds both + and - atoms (an inner salt).
    Raises SmilesParseError for unparseable input — callers decide the
    policy (split_reagent_combination treats it as 'unknown')."""
    from ..chem import parse_smiles
    mol = parse_smiles(smiles)
    positive = [a.charge for a in mol.atoms if a.charge > 0]
    negative = [a.charge for a in mol.atoms if a.charge < 0]
    if not positive and not negative:
        return MOL_CHARGE_CLASS[2], False
    if positive and not negative:
        return MOL_CHARGE_CLASS[0], False
    if negative and not positive:
        return MOL_CHARGE_CLASS[1], False
    total = sum(positive) + sum(negative)
    if total > 0:
        return MOL_CHARGE_CLASS[0], True
    if total < 0:
        return MOL_CHARGE_CLASS[1], True
    return MOL_CHARGE_CLASS[2], True


class IonicCompoundTable:
    """Ordered table of known ionic compounds; order matters — compounds are
    stripped first-match-first exactly like the reference MolRemover iterates
    self.salts (utils.py:82-90)."""

    def __init__(self, entries: Sequence[str]):
        self.entries: List[str] = []
        self._multisets: List[Counter] = []
        for entry in entries:
            entry = entry.strip()
            if not entry:
                continue
            frags = [canonical_smiles(f) for f in entry.split(".")]
            self.entries.append(".".join(frags))
            self._multisets.append(Counter(frags))

    @classmethod
    def load(cls, path: Optional[str] = None) -> "IonicCompoundTable":
        with open(path or _DEFAULT_TABLE) as f:
            return cls(f.readlines())

    def strip(self, fragments: Sequence[str]) -> Tuple[List[str], List[str]]:
        """Remove every whole occurrence of each table entry from the
        canonical fragment multiset. Returns (remaining fragments in input
        order, deleted entries in table order — each listed once, like
        MolRemover's `deleted`, utils.py:85-89)."""
        remaining = Counter(fragments)
        deleted: List[str] = []
        for entry, need in zip(self.entries, self._multisets):
            removed_any = False
            while all(remaining[f] >= n for f, n in need.items()):
                remaining.subtract(need)
                removed_any = True
            if removed_any:
                deleted.append(entry)
        out: List[str] = []
        tally = Counter(remaining)
        for f in fragments:
            if tally[f] > 0:
                out.append(f)
                tally[f] -= 1
        return out, deleted


def split_reagent_combination(reagent: Optional[str],
                              table: IonicCompoundTable
                              ) -> Tuple[List[str], List[str]]:
    """Reference 3.0.split_condition_and_slect.py:93-122: strip known ionic
    compounds, classify the rest by charge. Returns (known, unknown):
    known = charge-neutral leftovers + stripped ionic compounds (that order),
    unknown = charged leftovers (silently dropped from the reagent list by
    the caller; a row dies only when `known` is empty)."""
    if reagent is None or (isinstance(reagent, float)) or reagent == "":
        return [""], []  # NaN reagent keeps the row (3.0:96-98 else-branch)
    frags = [canonical_smiles(f) for f in str(reagent).split(".") if f]
    remaining, known_ionic = table.strip(frags)
    from ..chem.mol import SmilesParseError
    neutral, unknown = [], []
    for f in remaining:
        if not f:
            continue
        try:
            flag, _ = mol_charge(f)
        except (SmilesParseError, ValueError):
            # fragment outside the parser's subset (e.g. a chemical name):
            # unknown, like an RDKit MolFromSmiles failure in the reference
            # pipeline — it vanishes from the list; the row survives only
            # if something known remains
            unknown.append(f)
            continue
        (neutral if flag == MOL_CHARGE_CLASS[2] else unknown).append(f)
    return neutral + known_ionic, unknown
