"""Host-side chemistry kit (own SMILES stack; optional RDKit fast path).

Own copies of textreact_tpu/chem, pure Python: mol, canon, aromatic,
rdkit_bridge and fingerprints, and the template engine (smarts.py,
reaction.py) that decodes template-based retro predictions. The C++
accelerator (native.py) is not part of this package yet."""

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
