"""Optional RDKit fast path.

RDKit is not part of the baked environment; the chem kit is fully functional
without it. When RDKit *is* importable (e.g. a user environment that also
runs the reference), these wrappers provide bit-parity with reference
canonicalization (reference evaluate.py:27-32) and augmentation
(dataset.py:423-429).
"""

from __future__ import annotations

try:
    from rdkit import Chem, RDLogger  # type: ignore
    RDLogger.DisableLog("rdApp.*")
    HAS_RDKIT = True
except ImportError:
    Chem = None
    HAS_RDKIT = False


def rdkit_canonical_smiles(smiles: str) -> str:
    try:
        return Chem.CanonSmiles(smiles)
    except Exception:
        return smiles


def rdkit_random_smiles(smiles: str):
    try:
        mol = Chem.MolFromSmiles(smiles)
        new = Chem.MolToSmiles(mol, doRandom=True, canonical=False)
        import ast
        return new, list(ast.literal_eval(mol.GetProp("_smilesAtomOutputOrder")))
    except Exception:
        from ..tokenizers.smiles import ATOM_REGEX
        return smiles, list(range(len(ATOM_REGEX.findall(smiles))))
