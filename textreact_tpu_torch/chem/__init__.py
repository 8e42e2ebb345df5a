"""Host-side chemistry kit (own SMILES stack; optional RDKit fast path).

Own copies of what fingerprinting needs from textreact_tpu/chem: mol, canon,
aromatic, rdkit_bridge and fingerprints, pure Python. The C++ accelerator
(native.py) and the template modules (reaction.py, smarts.py) are not part
of this package yet."""

from .canon import (canonical_ranks, canonical_rxn_smiles, canonical_smiles,
                    canonical_smiles_strict, random_smiles, write_smiles)
from .fingerprints import (fingerprint_matrix, morgan_fingerprint,
                           reaction_difference_fingerprint)
from .mol import Atom, Bond, Mol, SmilesParseError, parse_smiles
from .rdkit_bridge import HAS_RDKIT

__all__ = [
    "Atom", "Bond", "Mol", "SmilesParseError", "parse_smiles",
    "canonical_ranks", "canonical_smiles", "canonical_smiles_strict",
    "canonical_rxn_smiles", "random_smiles", "write_smiles",
    "morgan_fingerprint", "reaction_difference_fingerprint",
    "fingerprint_matrix", "HAS_RDKIT",
]
