"""Aromaticity perception (kekulé → aromatic normalization).

RDKit sanitization perceives aromaticity at parse time, so the reference's
canonical SMILES and fingerprints are invariant to kekulé vs aromatic input
spellings (reference evaluate.py:27-40 compares canonical strings for the
retro metric; retrieve_faiss.py:36-44 fingerprints both). The own chem kit
must match: parse_smiles calls perceive_aromaticity after implicit-H
assignment.

Model (a deterministic subset of RDKit's default Hückel model, covering
USPTO organic chemistry):
- candidate rings: for every bond, the shortest cycle through it (BFS with
  adjacency-order tie-breaking), sizes 3..7, deduplicated;
- per-atom π contribution within a ring:
  * an in-ring double/aromatic bond        → 1 electron
  * an exocyclic double bond               → 0 electrons (sp2, e.g. quinone
                                             C=O, 2-pyridone carbonyl)
  * no double bond: lone pair / empty orbital by element+charge —
    N/P (q=0 or -1), O/S/Se/Te (q=0)       → 2;  C(q=-1) → 2;
    C(q=+1), B(q=0)                        → 0;  anything else → ineligible
  * triple bond, >3 sigma connections(+H), or a symbol outside
    {B,C,N,O,P,S,As,Se,Te}                 → ring ineligible
- a ring aromatizes when its π total is 4n+2; fused systems converge by
  fixpoint iteration (an aromatized ring's bonds count as in-ring aromatic
  for its neighbors — indole's 5-ring aromatizes after its 6-ring).
Per-ring counting means peripherally-conjugated systems whose individual
SSSR rings fail Hückel (azulene) stay kekulé — acceptable for USPTO data.

Perception only ever ADDS aromatic flags; already-aromatic input is
untouched, and implicit-H counts frozen at parse time are preserved (the
writer brackets atoms whose stored H differs from re-inference, e.g. the
pyrrole [nH] that a kekulé parse assigned H=1).
"""

from __future__ import annotations

from typing import List, Optional

from .mol import AROMATIC, DOUBLE, Mol, SINGLE, TRIPLE

AROMATIC_CAPABLE = {"B", "C", "N", "O", "P", "S", "As", "Se", "Te"}

_MAX_RING = 7


def _shortest_cycle_through(mol: Mol, bidx: int) -> Optional[List[int]]:
    """Shortest cycle containing bond bidx: BFS from a1 to a2 avoiding the
    bond itself; neighbors visited in adjacency order (deterministic)."""
    bond = mol.bonds[bidx]
    src, dst = bond.a1, bond.a2
    prev = {src: -1}
    queue = [src]
    depth = {src: 0}
    while queue:
        nxt: List[int] = []
        for a in queue:
            if depth[a] + 2 > _MAX_RING:
                return None
            for nb_bidx in mol.adj[a]:
                if nb_bidx == bidx:
                    continue
                o = mol.bonds[nb_bidx].other(a)
                if o in prev:
                    continue
                prev[o] = a
                depth[o] = depth[a] + 1
                if o == dst:
                    path = [o]
                    while path[-1] != src:
                        path.append(prev[path[-1]])
                    return path  # dst..src, length = ring size
                nxt.append(o)
        queue = nxt
    return None


def _candidate_rings(mol: Mol) -> List[List[int]]:
    rings: List[List[int]] = []
    seen = set()
    for bidx in range(len(mol.bonds)):
        ring = _shortest_cycle_through(mol, bidx)
        if ring is None or len(ring) < 3 or len(ring) > _MAX_RING:
            continue
        key = frozenset(ring)
        if key in seen:
            continue
        seen.add(key)
        rings.append(ring)
    return rings


def _ring_pi_electrons(mol: Mol, ring: List[int]) -> Optional[int]:
    """π electron count of the ring, or None if any atom disqualifies it."""
    ring_set = set(ring)
    total = 0
    for a in ring:
        atom = mol.atoms[a]
        if atom.symbol not in AROMATIC_CAPABLE:
            return None
        if mol.degree(a) + atom.total_h > 3:
            return None
        in_ring_pi = False
        exo_double = False
        for bidx in mol.adj[a]:
            b = mol.bonds[bidx]
            if b.order >= TRIPLE:
                return None
            is_pi = b.aromatic or b.order == AROMATIC or b.order == DOUBLE
            if not is_pi:
                continue
            if b.other(a) in ring_set:
                in_ring_pi = True
            elif b.order == DOUBLE:
                exo_double = True
        if in_ring_pi:
            total += 1
        elif exo_double:
            total += 0
        else:
            sym, q = atom.symbol, atom.charge
            if sym in ("N", "P", "As") and q in (0, -1):
                total += 2
            elif sym in ("O", "S", "Se", "Te") and q == 0:
                total += 2
            elif sym == "C" and q == -1:
                total += 2
            elif sym == "C" and q == 1:
                total += 0
            elif sym == "B" and q == 0:
                total += 0
            else:
                return None
    return total


def perceive_aromaticity(mol: Mol) -> None:
    """Mark Hückel-aromatic rings: atoms aromatic, in-ring bonds aromatic
    SINGLE with cleared stereo direction. Iterates to fixpoint so fused
    systems converge. H counts are left exactly as assigned at parse."""
    rings = _candidate_rings(mol)
    if not rings:
        return
    pending = list(range(len(rings)))
    changed = True
    while changed and pending:
        changed = False
        still = []
        for ri in pending:
            ring = rings[ri]
            ring_set = set(ring)
            already = all(mol.atoms[a].aromatic for a in ring) and all(
                b.aromatic for b in mol.bonds
                if b.a1 in ring_set and b.a2 in ring_set
                and _in_ring(ring, b.a1, b.a2))
            if already:
                continue
            pi = _ring_pi_electrons(mol, ring)
            if pi is not None and pi >= 2 and (pi - 2) % 4 == 0:
                for a in ring:
                    mol.atoms[a].aromatic = True
                for b in mol.bonds:
                    if (b.a1 in ring_set and b.a2 in ring_set
                            and _in_ring(ring, b.a1, b.a2)):
                        b.order = SINGLE
                        b.aromatic = True
                        b.direction = 0
                changed = True
            else:
                still.append(ri)
        pending = still


def _in_ring(ring: List[int], a1: int, a2: int) -> bool:
    """True when (a1, a2) is an EDGE of this cycle (not a chord)."""
    n = len(ring)
    for i in range(n):
        x, y = ring[i], ring[(i + 1) % n]
        if (x == a1 and y == a2) or (x == a2 and y == a1):
            return True
    return False
