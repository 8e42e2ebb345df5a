"""Small curation aides (own copy of textreact_tpu/preprocess/aides.py over
utils/table.py).

Roles of reference preprocess/uspto_script/extract_nosmiles.py (find
condition names with no SMILES), merge_comp.py (merge a Reaxys
name -> SMILES table into the condition columns), and
get_fragment_from_rxn_dataset.py (BRICS fragment inventory; RDKit-gated).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List

from ..chem import parse_smiles
from ..chem.mol import SmilesParseError
from ..utils.table import Table
from .condition_splits import CONDITION_COLS


def extract_non_smiles(values: Iterable[str]) -> List[str]:
    """Condition strings that do not parse as SMILES (chemical names),
    frequency-sorted (role of extract_nosmiles.py)."""
    counter: Counter = Counter()
    for v in values:
        if not v:
            continue
        try:
            parse_smiles(v)
        except (SmilesParseError, ValueError):
            counter[v] += 1
    return [name for name, _ in counter.most_common()]


def merge_name_to_smiles(df: Table, name_to_smiles: Dict[str, str]
                         ) -> Table:
    """Replace chemical names in the condition slots by their SMILES where
    a mapping exists (role of merge_comp.py)."""
    out = df.copy()
    for col in CONDITION_COLS:
        if col in out.columns:
            out[col] = [name_to_smiles.get(v, v) for v in out[col]]
    return out


def brics_fragments(smiles_list: Iterable[str]) -> Counter:
    """BRICS decomposition inventory over a molecule list (role of
    get_fragment_from_rxn_dataset.py). RDKit-gated: BRICS rules live in
    RDKit's C++ layer."""
    try:
        from rdkit.Chem import BRICS, MolFromSmiles
    except ImportError as e:
        raise NotImplementedError(
            "BRICS fragmentation uses RDKit (as in the reference)") from e
    counter: Counter = Counter()
    for smi in smiles_list:
        mol = MolFromSmiles(smi)
        if mol is None:
            continue
        counter.update(BRICS.BRICSDecompose(mol))
    return counter


def assign_conditions(reagent_smiles_set: Iterable[str],
                      role_compounds: Dict[str, Iterable[str]]
                      ) -> Dict[str, List[str]]:
    """Match a reaction's reagent molecules against per-role condition
    vocabularies (role of get_dataset_for_condition.py:15-48, the
    reference's WIP condition-assignment helper for USPTO-1k-TPL): a known
    condition compound (possibly multi-fragment) is assigned to a role iff
    ALL of its fragments appear among the reaction's reagent molecules.

    reagent_smiles_set: canonical single-fragment SMILES present in the
    reaction. role_compounds: role -> iterable of known condition compounds
    ('.'-joined fragments). Returns role -> matched compounds (input order).
    """
    present = set(reagent_smiles_set)
    out: Dict[str, List[str]] = {}
    for role, compounds in role_compounds.items():
        matched: List[str] = []
        for compound in compounds:
            frags = [f for f in str(compound).split(".") if f]
            if frags and all(f in present for f in frags):
                matched.append(compound)
        out[role] = matched
    return out
