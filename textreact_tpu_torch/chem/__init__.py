"""Host-side chemistry kit (own SMILES stack; optional RDKit fast path).

Own copies of textreact_tpu/chem: mol, canon, aromatic, rdkit_bridge and
fingerprints, the template engine (smarts.py, reaction.py) that decodes
template-based retro predictions, and the C++ accelerator (native.py +
_cchem.cpp) through which fingerprint_matrix and the retro metric's
canonicalization go."""

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
