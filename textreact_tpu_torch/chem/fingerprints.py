"""Hashed circular (ECFP/Morgan-style) fingerprints + reaction difference fps.

Fills the role of RDKit's GetMorganFingerprintAsBitVect and
CreateDifferenceFingerprintForReaction in the reference retriever
(reference retrieve/retrieve_faiss.py:18-50). The hashing is a deterministic
32-bit mix (no salted python hash), so fingerprints are stable across
processes, and the same in this Python implementation and the C++ route
(chem/native.py) that `fingerprint_matrix` takes unless called with
`native=False`. Own copy of textreact_tpu/chem/fingerprints.py.

Divergence note: RDKit's reaction difference fingerprint defaults to the
AtomPair family; here the difference fingerprint is built from Morgan count
vectors. Retrieval-parity tests compare the engine against a brute-force
numpy scan of the *same* vectors, which is the property FAISS-flat parity
is defined over.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .canon import parse_smiles
from .mol import AROMATIC, Mol

_MASK32 = 0xFFFFFFFF


def _mix(h: int, v: int) -> int:
    """Deterministic 32-bit hash combine (xorshift-multiply)."""
    h = (h ^ (v & _MASK32)) & _MASK32
    h = (h * 0x9E3779B1) & _MASK32
    h ^= h >> 16
    return h


def _hash_ints(vals) -> int:
    h = 0x811C9DC5
    for v in vals:
        h = _mix(h, v)
    return h


def _ring_membership(mol: Mol) -> List[bool]:
    """Atom is in a ring iff it lies on some cycle: iteratively prune
    degree<=1 atoms; survivors with degree>=2 are ring atoms."""
    n = len(mol.atoms)
    deg = [mol.degree(i) for i in range(n)]
    removed = [False] * n
    stack = [i for i in range(n) if deg[i] <= 1]
    while stack:
        a = stack.pop()
        if removed[a]:
            continue
        removed[a] = True
        for nb in mol.neighbors(a):
            if not removed[nb]:
                deg[nb] -= 1
                if deg[nb] <= 1:
                    stack.append(nb)
    return [not removed[i] and mol.degree(i) > 0 for i in range(n)]


def morgan_identifiers(mol: Mol, radius: int = 2) -> List[int]:
    """All circular-environment identifiers of all atoms at radii 0..radius."""
    in_ring = _ring_membership(mol)
    ids = []
    current: List[int] = []
    for a, atom in enumerate(mol.atoms):
        ident = _hash_ints((
            atom.atomic_num, mol.degree(a), atom.total_h, atom.charge,
            int(atom.aromatic), int(in_ring[a]), atom.isotope,
        ))
        current.append(ident)
    ids.extend(current)
    for r in range(1, radius + 1):
        nxt: List[int] = []
        for a in range(len(mol.atoms)):
            env = []
            for b in mol.adj[a]:
                bond = mol.bonds[b]
                bkey = AROMATIC if bond.aromatic else bond.order
                env.append((bkey, current[bond.other(a)]))
            env.sort()
            flat = [r, current[a]]
            for bkey, nid in env:
                flat.extend((bkey, nid))
            nxt.append(_hash_ints(flat))
        ids.extend(nxt)
        current = nxt
    return ids


def morgan_fingerprint(smiles: str, radius: int = 2, n_bits: int = 1024,
                       counts: bool = False) -> np.ndarray:
    """Hashed circular fingerprint of a molecule SMILES.

    Binary (uint8 0/1) by default — the drop-in for the reference's 1024-bit
    Morgan retriever vectors (retrieve_faiss.py:36-44). Unparseable SMILES
    fall back to methane's fingerprint, matching the reference's except
    branch (retrieve_faiss.py:42-43).
    """
    try:
        from .mol import remove_explicit_hydrogens
        # RDKit fingerprints post-MolFromSmiles mols (explicit H folded)
        mol = remove_explicit_hydrogens(parse_smiles(smiles))
        if not mol.atoms:
            raise ValueError("empty molecule")
    except Exception:
        if smiles == "C":
            raise
        return morgan_fingerprint("C", radius=radius, n_bits=n_bits, counts=counts)
    vec = np.zeros((n_bits,), dtype=np.int32 if counts else np.uint8)
    for ident in morgan_identifiers(mol, radius):
        slot = ident % n_bits
        if counts:
            vec[slot] += 1
        else:
            vec[slot] = 1
    return vec


def reaction_difference_fingerprint(rxn_smiles: str, radius: int = 2,
                                    n_bits: int = 2048) -> np.ndarray:
    """Difference fingerprint of a reaction SMILES (products − reactants),
    as an int32 count vector (role of retrieve_faiss.py:18-27)."""
    parts = rxn_smiles.split(">")
    if len(parts) == 3:
        reactant_str, _agents, product_str = parts
    elif len(parts) == 1:
        raise ValueError(f"not a reaction SMILES: {rxn_smiles!r}")
    else:
        reactant_str, product_str = parts[0], parts[-1]
    diff = np.zeros((n_bits,), dtype=np.int32)
    for part, sign in ((product_str, 1), (reactant_str, -1)):
        for smi in part.split("."):
            if not smi:
                continue
            diff += sign * morgan_fingerprint(smi, radius=radius, n_bits=n_bits,
                                              counts=True).astype(np.int32)
    return diff


def fingerprint_matrix(smiles_list, kind: str = "morgan", n_bits: Optional[int] = None,
                       num_workers: int = 0, native: bool = True) -> np.ndarray:
    """Fingerprint a list of SMILES into a (N, d) matrix.

    kind='morgan' (binary uint8, d=1024) for molecules (retro retrieval);
    kind='reaction' (int32 counts, d=2048) for reaction SMILES (RCR
    retrieval). `num_workers>0` uses a process pool like the reference
    (retrieve_faiss.py:30-33). `native` takes the C++ route: one call for
    a Morgan matrix, a call per reaction (in the workers when pooled).
    """
    if kind == "morgan":
        n_bits = n_bits or 1024
        if native:
            from .native import native_morgan_batch
            return native_morgan_batch(list(smiles_list), n_bits=n_bits
                                       ).astype(np.uint8)
        fn = _MorganWorker(n_bits)
    elif kind == "reaction":
        n_bits = n_bits or 2048
        fn = (_NativeReactionWorker if native else _ReactionWorker)(n_bits)
    else:
        raise ValueError(kind)
    if num_workers and num_workers > 1:
        import multiprocessing
        with multiprocessing.Pool(num_workers) as p:
            fps = p.map(fn, list(smiles_list), chunksize=128)
    else:
        fps = [fn(s) for s in smiles_list]
    return np.stack(fps)


class _MorganWorker:
    def __init__(self, n_bits: int):
        self.n_bits = n_bits

    def __call__(self, smiles: str) -> np.ndarray:
        return morgan_fingerprint(smiles, n_bits=self.n_bits)


class _ReactionWorker:
    def __init__(self, n_bits: int):
        self.n_bits = n_bits

    def __call__(self, smiles: str) -> np.ndarray:
        try:
            return reaction_difference_fingerprint(smiles, n_bits=self.n_bits)
        except Exception:
            return np.zeros((self.n_bits,), dtype=np.int32)


class _NativeReactionWorker:
    def __init__(self, n_bits: int):
        self.n_bits = n_bits

    def __call__(self, smiles: str) -> np.ndarray:
        from .native import native_reaction_fingerprint
        try:
            return native_reaction_fingerprint(smiles, n_bits=self.n_bits)
        except ValueError:
            return np.zeros((self.n_bits,), dtype=np.int32)
