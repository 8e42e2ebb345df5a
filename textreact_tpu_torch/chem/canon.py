"""Canonical SMILES: Morgan-style rank refinement + deterministic DFS writer.

Fills the role RDKit's Chem.CanonSmiles / Chem.MolToSmiles play in the
reference (evaluate.py:27-32, dataset.py:423-429). The ranking is
self-consistent — the same molecular graph yields the same string regardless
of input atom order — which is the property the evaluation protocol actually
needs (prediction and gold are canonicalized by the same function before
string comparison). It is not guaranteed to be bit-identical to RDKit's
output; rdkit_bridge.py switches to RDKit when available.
"""

from __future__ import annotations

import random as _random
from typing import Dict, List, Optional, Sequence, Tuple

from .mol import (AROMATIC, CHI_CCW, CHI_CW, CHI_NONE, DOUBLE, Mol, QUAD,
                  SINGLE, TRIPLE, SmilesParseError, parse_smiles)

_BOND_SYMBOL = {SINGLE: "", DOUBLE: "=", TRIPLE: "#", QUAD: "$"}


# --------------------------------------------------------------------------
# Canonical ranking (iterative neighborhood refinement)
# --------------------------------------------------------------------------

def canonical_ranks(mol: Mol, atom_subset: Optional[Sequence[int]] = None,
                    tie_break: bool = True) -> Dict[int, int]:
    """Assign a canonical rank to each atom (lower = earlier in output).

    Initial invariant: (atomic number, degree, charge, total H, aromaticity,
    isotope); then Weisfeiler-Lehman refinement over sorted neighbor
    (rank, bond-key) multisets until the partition stabilizes, with
    deterministic tie-breaking by splitting the lowest tied class.
    tie_break=False returns the (possibly non-discrete) refinement fixpoint
    — the partition into graph-equivalence classes used by
    drop_nonstereogenic_tags.
    """
    atoms = list(atom_subset) if atom_subset is not None else list(range(len(mol.atoms)))
    in_set = set(atoms)

    def bond_key(b) -> int:
        return AROMATIC + 1 if b.aromatic else b.order

    inv: Dict[int, Tuple] = {}
    for a in atoms:
        at = mol.atoms[a]
        inv[a] = (at.atomic_num, mol.degree(a), at.charge, at.total_h,
                  int(at.aromatic), at.isotope)

    ranks = _ranks_from_keys(atoms, inv)

    def refine(ranks: Dict[int, int]) -> Dict[int, int]:
        while True:
            keys = {}
            for a in atoms:
                nbr = sorted(
                    (bond_key(mol.bonds[b]), ranks[mol.bonds[b].other(a)])
                    for b in mol.adj[a] if mol.bonds[b].other(a) in in_set
                )
                keys[a] = (ranks[a], tuple(nbr))
            new_ranks = _ranks_from_keys(atoms, keys)
            if len(set(new_ranks.values())) == len(set(ranks.values())):
                return new_ranks
            ranks = new_ranks

    ranks = refine(ranks)

    # Stereo-aware refinement: split rank-tied chiral atoms by a
    # spelling-invariant descriptor — the parsed tag composed with the
    # parity of (SMILES neighbor order -> rank order). Without this, a
    # meso compound (e.g. meso-tartaric acid) written from either end
    # yields two different "canonical" strings: the tied centers are
    # graph-equivalent ignoring stereo, and the index tie-break below
    # would follow input order.
    from .mol import H_MARKER
    nbr_order = getattr(mol, "smiles_neighbor_order", {})

    def chiral_descriptor(a: int, r: Dict[int, int]) -> int:
        at = mol.atoms[a]
        if at.chirality == CHI_NONE:
            return 0
        orig = list(nbr_order.get(a, []))
        if not orig:
            return 0
        keys = []
        for x in orig:
            if x == H_MARKER:
                keys.append(-1)
            elif x in r:
                keys.append(r[x])
            else:
                return 0  # neighbor outside the ranked subset
        if len(set(keys)) != len(keys):
            return 0  # tied neighbors: parity ill-defined at this stage
        order = sorted(range(len(orig)), key=lambda i: keys[i])
        if _permutation_parity(order):
            return CHI_CW if at.chirality == CHI_CCW else CHI_CCW
        return at.chirality

    while any(mol.atoms[a].chirality != CHI_NONE for a in atoms):
        keys = {a: (ranks[a], chiral_descriptor(a, ranks)) for a in atoms}
        new_ranks = refine(_ranks_from_keys(atoms, keys))
        if len(set(new_ranks.values())) == len(set(ranks.values())):
            break
        ranks = new_ranks

    if not tie_break:
        return ranks

    # Tie-break until discrete: split the smallest-rank tied class by
    # promoting one member (deterministically: the one with the smallest
    # current rank-stable signature, falling back to input index — for
    # refinement-stable classes these are graph-equivalent in practice).
    while len(set(ranks.values())) < len(atoms):
        by_rank: Dict[int, List[int]] = {}
        for a in atoms:
            by_rank.setdefault(ranks[a], []).append(a)
        tied_rank = min(r for r, members in by_rank.items() if len(members) > 1)
        chosen = min(by_rank[tied_rank])
        keys = {a: (ranks[a], 0 if a == chosen else 1) for a in atoms}
        ranks = refine(_ranks_from_keys(atoms, keys))
    return ranks


def _ranks_from_keys(atoms: Sequence[int], keys: Dict[int, Tuple]) -> Dict[int, int]:
    order = sorted(set(keys[a] for a in atoms))
    pos = {k: i for i, k in enumerate(order)}
    return {a: pos[keys[a]] for a in atoms}


# --------------------------------------------------------------------------
# SMILES writer
# --------------------------------------------------------------------------

def _reader_inferred_h(mol: Mol, idx: int) -> int:
    """Implicit-H count a SMILES reader would assign to this atom written as
    a bare organic-subset symbol (mirror of Mol.assign_implicit_h)."""
    from .mol import DEFAULT_VALENCES
    at = mol.atoms[idx]
    order_sum = 0
    for b in mol.adj[idx]:
        bond = mol.bonds[b]
        order_sum += 1 if bond.aromatic else bond.order
    if at.aromatic and at.symbol in ("B", "C", "N", "P"):
        order_sum += 1
    vals = DEFAULT_VALENCES.get(at.symbol, ())
    if at.aromatic:
        # mirror of Mol.assign_implicit_h: no valence promotion for
        # aromatic atoms (bare 3-connected aromatic N has zero H)
        return max(0, vals[0] - order_sum) if vals else 0
    for val in vals:
        if order_sum <= val:
            return val - order_sum
    return 0


def _atom_token(mol: Mol, idx: int, chirality_out: int) -> str:
    at = mol.atoms[idx]
    sym = at.symbol.lower() if at.aromatic else at.symbol
    needs_bracket = (
        at.symbol not in ("B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I", "*")
        or at.charge != 0 or at.isotope != 0 or chirality_out != CHI_NONE
        # bracket whenever the H count a reader would infer from the bare
        # symbol differs from the actual count (e.g. pyrrole [nH])
        or at.total_h != _reader_inferred_h(mol, idx)
        or at.atom_map != 0
    )
    # organic-subset atom whose implicit-H recomputation matches: plain token
    if not needs_bracket:
        return sym
    parts = ["["]
    if at.isotope:
        parts.append(str(at.isotope))
    parts.append(sym)
    if chirality_out == CHI_CCW:
        parts.append("@")
    elif chirality_out == CHI_CW:
        parts.append("@@")
    h = at.total_h
    if h == 1:
        parts.append("H")
    elif h > 1:
        parts.append(f"H{h}")
    if at.charge:
        if at.charge == 1:
            parts.append("+")
        elif at.charge == -1:
            parts.append("-")
        else:
            parts.append(f"{at.charge:+d}")
    if at.atom_map:
        parts.append(f":{at.atom_map}")
    parts.append("]")
    return "".join(parts)


def _permutation_parity(perm: Sequence[int]) -> int:
    """0 even, 1 odd."""
    perm = list(perm)
    parity = 0
    for i in range(len(perm)):
        while perm[i] != i:
            j = perm[i]
            perm[i], perm[j] = perm[j], perm[i]
            parity ^= 1
    return parity


def write_smiles(mol: Mol, rank_of: Optional[Dict[int, int]] = None,
                 atom_subset: Optional[Sequence[int]] = None,
                 start: Optional[int] = None,
                 rng: Optional[_random.Random] = None,
                 with_atom_order: bool = False,
                 atom_token_fn=None,
                 all_bonds_explicit: bool = False):
    """Serialize (a fragment of) a Mol to SMILES.

    With `rank_of`, traversal is deterministic in rank order (canonical);
    with `rng`, neighbor order is randomized (for SMILES augmentation,
    replacing reference dataset.py:423-429 doRandom=True).
    Returns the string, or (string, atom_output_order) with
    `with_atom_order=True` where atom_output_order[i] = original atom idx of
    the i-th written atom (parity with RDKit's _smilesAtomOutputOrder).

    `atom_token_fn(idx, chirality_out) -> str` overrides the per-atom token
    (role of RDKit MolFragmentToSmiles atomSymbols=; the template extractor
    passes strict SMARTS labels); `all_bonds_explicit=True` writes every
    bond symbol, aromatic as ':' (role of allBondsExplicit=True).
    """
    atoms = list(atom_subset) if atom_subset is not None else list(range(len(mol.atoms)))
    in_set = set(atoms)
    if not atoms:
        return ("", []) if with_atom_order else ""

    if start is None:
        if rank_of is not None:
            start = min(atoms, key=lambda a: rank_of[a])
        elif rng is not None:
            start = rng.choice(atoms)
        else:
            start = atoms[0]

    def nbr_sort(a: int, bidxs: List[int]) -> List[int]:
        if rng is not None:
            out = list(bidxs)
            rng.shuffle(out)
            return out
        if rank_of is not None:
            # out-of-subset neighbors (skipped by the traversal) sort last
            big = len(mol.atoms)
            return sorted(bidxs,
                          key=lambda b: rank_of.get(mol.bonds[b].other(a), big))
        return list(bidxs)

    # --- pass 1: recursive DFS (same order as serialization) classifying
    # each bond as tree edge or ring closure
    visited = {start}
    parent_bond: Dict[int, int] = {}
    children: Dict[int, List[int]] = {a: [] for a in atoms}  # bond idxs
    ring_bonds_at: Dict[int, List[int]] = {a: [] for a in atoms}
    seen_bonds = set()

    def classify(a: int) -> None:
        for b in nbr_sort(a, mol.adj[a]):
            if b in seen_bonds:
                continue
            o = mol.bonds[b].other(a)
            if o not in in_set:
                continue
            seen_bonds.add(b)
            if o in visited:
                ring_bonds_at[a].append(b)
                ring_bonds_at[o].append(b)
            else:
                visited.add(o)
                parent_bond[o] = b
                children[a].append(b)
                classify(o)

    ring_digit: Dict[int, int] = {}
    next_digit = [1]
    free_digits: List[int] = []

    def alloc_digit() -> int:
        if free_digits:
            return free_digits.pop(0)
        d = next_digit[0]
        next_digit[0] += 1
        return d

    def digit_token(d: int, bond_sym: str) -> str:
        return f"{bond_sym}%{d:02d}" if d >= 10 else f"{bond_sym}{d}"

    atom_output_order: List[int] = []
    pieces: List[str] = []
    # Canonical normalization of cis/trans direction symbols: flipping every
    # direction in a connected stereo cluster is a no-op, so after a first
    # write pass we flip clusters whose first-emitted symbol is '\' and write
    # again (dir_flip is filled between passes).
    dir_flip: Dict[int, bool] = {}
    dir_emit_order: List[Tuple[int, str]] = []

    def bond_symbol(b, src: int) -> str:
        bond = mol.bonds[b]
        if bond.aromatic:
            # aromatic-aromatic bonds are implicit; aromatic flag on bond
            # implies both ends aromatic here
            return ":" if all_bonds_explicit else ""
        if bond.direction != 0:
            up = bond.direction == +1
            if bond.a1 != src:
                up = not up
            if dir_flip.get(b, False):
                up = not up
            sym = "/" if up else "\\"
            dir_emit_order.append((b, sym))
            return sym
        if bond.order == SINGLE:
            if all_bonds_explicit:
                return "-"
            a1, a2 = mol.atoms[bond.a1], mol.atoms[bond.a2]
            if a1.aromatic and a2.aromatic:
                return "-"  # explicit single between two aromatic atoms
            return ""
        return _BOND_SYMBOL[bond.order]

    def bond_symbol_ring(b, src: int) -> str:
        """Ring-closure digits drop direction markers (emitting them at both
        endpoints is ambiguous across SMILES dialects)."""
        bond = mol.bonds[b]
        if bond.direction != 0 and not bond.aromatic and bond.order == SINGLE:
            return "-" if all_bonds_explicit else ""
        return bond_symbol(b, src)

    from .mol import H_MARKER

    def chirality_out(a: int, written_nbrs: List[int]) -> int:
        """Map the parsed chiral tag onto the output neighbor order: an odd
        permutation of the neighbor list flips @ <-> @@."""
        at = mol.atoms[a]
        if at.chirality == CHI_NONE:
            return CHI_NONE
        orig = list(getattr(mol, "smiles_neighbor_order", {}).get(a, []))
        new = list(written_nbrs)
        if len(orig) != len(new) or set(orig) != set(new):
            return at.chirality  # fallback: keep tag
        perm = [orig.index(x) for x in new]
        if _permutation_parity(perm):
            return CHI_CW if at.chirality == CHI_CCW else CHI_CCW
        return at.chirality

    def write_atom(a: int) -> None:
        atom_output_order.append(a)
        # output neighbor order: parent, [implicit H], ring closures, children
        written: List[int] = []
        if a in parent_bond:
            written.append(mol.bonds[parent_bond[a]].other(a))
        at = mol.atoms[a]
        if at.chirality != CHI_NONE and at.explicit_h == 1:
            written.append(H_MARKER)
        ring_partners = [mol.bonds[b].other(a) for b in ring_bonds_at[a]]
        written.extend(ring_partners)
        child_partners = [mol.bonds[b].other(a) for b in children[a]]
        written.extend(child_partners)
        chi = chirality_out(a, written)
        pieces.append(atom_token_fn(a, chi) if atom_token_fn is not None
                      else _atom_token(mol, a, chi))
        # ring closure digits
        for b in ring_bonds_at[a]:
            if b in ring_digit:
                d = ring_digit.pop(b)
                free_digits.append(d)
                free_digits.sort()
                pieces.append(digit_token(d, bond_symbol_ring(b, a)))
            else:
                d = alloc_digit()
                ring_digit[b] = d
                pieces.append(digit_token(d, bond_symbol_ring(b, a)))
        # children
        kids = children[a]
        for i, b in enumerate(kids):
            o = mol.bonds[b].other(a)
            last = i == len(kids) - 1
            if not last:
                pieces.append("(")
            pieces.append(bond_symbol(b, a))
            write_atom(o)
            if not last:
                pieces.append(")")

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 10 * len(atoms)))
    try:
        classify(start)
        write_atom(start)
        if rank_of is not None and dir_emit_order:
            _fill_direction_flips(mol, dir_emit_order, dir_flip)
            if any(dir_flip.values()):
                pieces.clear()
                atom_output_order.clear()
                ring_digit.clear()
                free_digits.clear()
                next_digit[0] = 1
                dir_emit_order.clear()
                write_atom(start)
    finally:
        sys.setrecursionlimit(old_limit)

    smiles = "".join(pieces)
    if with_atom_order:
        return smiles, atom_output_order
    return smiles


def _fill_direction_flips(mol: Mol, emit_order, dir_flip: Dict[int, bool]) -> None:
    """Group directional bonds into stereo clusters (connected via shared
    atoms or via the double bond they flank) and flip every cluster whose
    first-emitted symbol is '\\' so canonical output always leads with '/'."""
    dir_bonds = sorted({b for b, _ in emit_order})
    parent = {b: b for b in dir_bonds}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(x, y):
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[rx] = ry

    at_atom: Dict[int, List[int]] = {}
    for b in dir_bonds:
        bond = mol.bonds[b]
        at_atom.setdefault(bond.a1, []).append(b)
        at_atom.setdefault(bond.a2, []).append(b)
    for bonds in at_atom.values():
        for other in bonds[1:]:
            union(bonds[0], other)
    for dbond in mol.bonds:
        if dbond.order == DOUBLE and not dbond.aromatic:
            b1s = at_atom.get(dbond.a1, [])
            b2s = at_atom.get(dbond.a2, [])
            if b1s and b2s:
                union(b1s[0], b2s[0])
    first_sym: Dict[int, str] = {}
    for b, sym in emit_order:
        root = find(b)
        if root not in first_sym:
            first_sym[root] = sym
    for b in dir_bonds:
        dir_flip[b] = first_sym[find(b)] == "\\"


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def canonical_smiles(smiles: str) -> str:
    """Canonical form of a (possibly multi-fragment) SMILES; the input is
    returned unchanged if it does not parse (reference evaluate.py:27-32)."""
    try:
        return canonical_smiles_strict(smiles)
    except (SmilesParseError, ValueError, KeyError, RecursionError):
        return smiles


def drop_nonstereogenic_tags(mol: Mol) -> None:
    """Clear tetrahedral tags on atoms with two graph-equivalent neighbors
    at the stereo-aware refinement fixpoint (RDKit-legacy sanitize parity).

    Dependent ring-fusion stereo — decalin's fusion carbons, whose two ring
    arms are identical substituents — cannot be ordered by any spelling-
    invariant rule: keeping such tags makes the 'canonical' string follow
    input order (found by the round-5 golden extension). RDKit's legacy
    AssignStereochemistry(cleanIt=True), which the reference hits on every
    MolFromSmiles (evaluate.py:27-32, template_decoder.py validate_mols),
    removes exactly these tags; dropping them restores spelling invariance
    AND string parity. Iterates: removing one tag can make another atom's
    neighbors equivalent. In place.
    """
    while True:
        chiral = [a for a in range(len(mol.atoms))
                  if mol.atoms[a].chirality != CHI_NONE]
        if not chiral:
            return
        ranks = canonical_ranks(mol, tie_break=False)
        dropped = False
        for a in chiral:
            nbr_ranks = [ranks[x] for x in mol.neighbors(a)]
            if len(set(nbr_ranks)) != len(nbr_ranks):
                mol.atoms[a].chirality = CHI_NONE
                dropped = True
        if not dropped:
            return


def canonical_smiles_strict(smiles: str) -> str:
    from .mol import remove_explicit_hydrogens
    # RDKit's MolFromSmiles strips removable explicit [H] atoms at parse
    # (removeHs default), so '[H]OC' and 'OC' share one reference canonical;
    # fold the same way (isotopic/charged/mapped/multi-bonded H atoms kept)
    mol = remove_explicit_hydrogens(parse_smiles(smiles))
    drop_nonstereogenic_tags(mol)
    ranks = canonical_ranks(mol)
    frags = [write_smiles(mol, rank_of=ranks, atom_subset=frag)
             for frag in mol.fragment_atom_sets()]
    return ".".join(sorted(frags))


def canonical_rxn_smiles(rxn_smiles: str) -> str:
    """Canonicalize each side of a reaction SMILES."""
    parts = rxn_smiles.split(">")
    return ">".join(canonical_smiles(p) if p else p for p in parts)


def random_smiles(smiles: str, rng: Optional[_random.Random] = None):
    """Random-order SMILES + atom output order (reference dataset.py:423-429).

    Falls back to (input, identity order over atom tokens) on parse failure,
    matching the reference's except branch.
    """
    rng = rng or _random
    try:
        mol = parse_smiles(smiles)
        rnd = rng if isinstance(rng, _random.Random) else _random.Random(rng.random())
        frags = mol.fragment_atom_sets()
        out_frags = []
        order: List[int] = []
        for frag in frags:
            s, o = write_smiles(mol, rng=rnd, atom_subset=frag, with_atom_order=True)
            out_frags.append(s)
            order.extend(o)
        return ".".join(out_frags), order
    except (SmilesParseError, ValueError, KeyError, RecursionError):
        from ..tokenizers.smiles import ATOM_REGEX
        return smiles, list(range(len(ATOM_REGEX.findall(smiles))))
