"""Molecular graph + SMILES parser, implemented from scratch.

The reference delegates all chemistry to RDKit (C++). RDKit is not part of
this framework's baked environment, so the chemistry kit is first-class code
here: a SMILES parser producing an explicit molecular graph, implicit-H
assignment, and (in canon.py / fingerprints.py) canonicalization and ECFP
fingerprints. When RDKit *is* importable, rdkit_bridge.py transparently
switches the hot entry points to it for bit-parity with reference outputs
(reference textreact/evaluate.py:27-32, retrieve/retrieve_faiss.py:36-44).

Supported SMILES features: organic subset + bracket atoms (isotope, charge,
explicit H, atom map, chirality @/@@), bonds - = # $ : ~ / \\, branches,
ring closures (incl. %nn), dots, aromatic lowercase atoms.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

# Periodic table subset: symbol -> atomic number (enough for USPTO organics
# plus common metals/catalysts appearing in condition strings).
ATOMIC_NUM: Dict[str, int] = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9,
    "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15, "S": 16,
    "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Sc": 21, "Ti": 22, "V": 23,
    "Cr": 24, "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29, "Zn": 30,
    "Ga": 31, "Ge": 32, "As": 33, "Se": 34, "Br": 35, "Kr": 36, "Rb": 37,
    "Sr": 38, "Y": 39, "Zr": 40, "Nb": 41, "Mo": 42, "Tc": 43, "Ru": 44,
    "Rh": 45, "Pd": 46, "Ag": 47, "Cd": 48, "In": 49, "Sn": 50, "Sb": 51,
    "Te": 52, "I": 53, "Xe": 54, "Cs": 55, "Ba": 56, "La": 57, "Ce": 58,
    "Pr": 59, "Nd": 60, "Sm": 62, "Eu": 63, "Gd": 64, "Tb": 65, "Dy": 66,
    "Ho": 67, "Er": 68, "Tm": 69, "Yb": 70, "Lu": 71, "Hf": 72, "Ta": 73,
    "W": 74, "Re": 75, "Os": 76, "Ir": 77, "Pt": 78, "Au": 79, "Hg": 80,
    "Tl": 81, "Pb": 82, "Bi": 83, "Po": 84, "At": 85, "Rn": 86, "Fr": 87,
    "Ra": 88, "Ac": 89, "Th": 90, "Pa": 91, "U": 92,
}

# Default valences for implicit-H assignment (Daylight organic subset).
DEFAULT_VALENCES: Dict[str, Tuple[int, ...]] = {
    "B": (3,), "C": (4,), "N": (3, 5), "O": (2,), "P": (3, 5),
    "S": (2, 4, 6), "F": (1,), "Cl": (1,), "Br": (1,), "I": (1,),
}

ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
AROMATIC_SYMBOLS = {"b", "c", "n", "o", "p", "s", "se", "as", "te"}

# Bond orders; AROMATIC is order 1.5 conceptually but tracked as a flag.
SINGLE, DOUBLE, TRIPLE, QUAD, AROMATIC = 1, 2, 3, 4, 5

_BOND_CHAR = {"-": SINGLE, "=": DOUBLE, "#": TRIPLE, "$": QUAD, ":": AROMATIC,
              "/": SINGLE, "\\": SINGLE, "~": SINGLE}

# Chirality tags
CHI_NONE, CHI_CW, CHI_CCW = 0, 1, 2  # @@=CW, @=CCW (anticlockwise)

# Sentinel used in per-atom SMILES neighbor-order lists for a bracket H on a
# chiral center (the H is not a graph atom but occupies a chirality slot).
H_MARKER = -1000


@dataclasses.dataclass
class Atom:
    symbol: str                 # canonical-case element symbol ("C", "Cl", ...)
    aromatic: bool = False
    charge: int = 0
    isotope: int = 0
    explicit_h: int = -1        # -1: compute implicit; >=0: bracket-specified
    atom_map: int = 0
    chirality: int = CHI_NONE
    # filled after parsing:
    implicit_h: int = 0
    idx: int = -1

    @property
    def atomic_num(self) -> int:
        return ATOMIC_NUM.get(self.symbol, 0)

    @property
    def total_h(self) -> int:
        return self.explicit_h if self.explicit_h >= 0 else self.implicit_h


@dataclasses.dataclass
class Bond:
    a1: int
    a2: int
    order: int = SINGLE
    aromatic: bool = False
    direction: int = 0          # 0 none, +1 '/' (up) from a1->a2, -1 '\\'

    def other(self, idx: int) -> int:
        return self.a2 if idx == self.a1 else self.a1


class Mol:
    """An explicit molecular graph."""

    def __init__(self) -> None:
        self.atoms: List[Atom] = []
        self.bonds: List[Bond] = []
        self.adj: List[List[int]] = []   # atom idx -> list of bond indices

    def add_atom(self, atom: Atom) -> int:
        atom.idx = len(self.atoms)
        self.atoms.append(atom)
        self.adj.append([])
        return atom.idx

    def add_bond(self, a1: int, a2: int, order: int = SINGLE,
                 aromatic: bool = False, direction: int = 0) -> int:
        bond = Bond(a1, a2, order, aromatic, direction)
        bidx = len(self.bonds)
        self.bonds.append(bond)
        self.adj[a1].append(bidx)
        self.adj[a2].append(bidx)
        return bidx

    def neighbors(self, idx: int) -> List[int]:
        return [self.bonds[b].other(idx) for b in self.adj[idx]]

    def bond_between(self, a1: int, a2: int) -> Optional[Bond]:
        for b in self.adj[a1]:
            if self.bonds[b].other(a1) == a2:
                return self.bonds[b]
        return None

    def degree(self, idx: int) -> int:
        return len(self.adj[idx])

    # --- implicit hydrogens ------------------------------------------------
    def assign_implicit_h(self) -> None:
        for atom in self.atoms:
            if atom.explicit_h >= 0:
                atom.implicit_h = atom.explicit_h
                continue
            if atom.symbol not in ORGANIC_SUBSET or atom.charge != 0:
                atom.implicit_h = 0
                continue
            order_sum = 0
            for b in self.adj[atom.idx]:
                bond = self.bonds[b]
                order_sum += 1 if bond.aromatic else bond.order
            # Aromatic B/C/N/P carry one delocalized π bond beyond their sigma
            # skeleton; aromatic O/S do not (furan/thiophene heteroatoms).
            if atom.aromatic and atom.symbol in ("B", "C", "N", "P"):
                order_sum += 1
            if atom.aromatic:
                # no valence promotion inside an aromatic ring: a bare
                # 3-connected aromatic N (N-substituted pyrrole/imidazole,
                # caffeine ring N) has ZERO implicit H — only [nH] carries
                # one. Promotion to the next valence (N->5) would invent it.
                h = max(0, DEFAULT_VALENCES[atom.symbol][0] - order_sum)
            else:
                h = 0
                for val in DEFAULT_VALENCES[atom.symbol]:
                    if order_sum <= val:
                        h = val - order_sum
                        break
            atom.implicit_h = h

    def fragment_atom_sets(self) -> List[List[int]]:
        """Connected components, in first-atom order."""
        seen = [False] * len(self.atoms)
        comps: List[List[int]] = []
        for start in range(len(self.atoms)):
            if seen[start]:
                continue
            stack, comp = [start], []
            seen[start] = True
            while stack:
                a = stack.pop()
                comp.append(a)
                for nb in self.neighbors(a):
                    if not seen[nb]:
                        seen[nb] = True
                        stack.append(nb)
            comps.append(sorted(comp))
        return comps


class SmilesParseError(ValueError):
    pass


def remove_explicit_hydrogens(mol: Mol) -> Mol:
    """Fold removable explicit [H] atoms into their neighbor's H count
    (role of RDKit AllChem.RemoveHs, reference template_extractor.py:541-542).

    An H atom is kept when it is charged, isotopic, atom-mapped, not
    single-bonded to exactly one heavy atom, or bonded to another H —
    mirroring RDKit's conservative defaults.
    """
    drop = set()
    for atom in mol.atoms:
        if atom.symbol != "H" or atom.charge != 0 or atom.isotope != 0 \
                or atom.atom_map != 0:
            continue
        if len(mol.adj[atom.idx]) != 1:
            continue
        bond = mol.bonds[mol.adj[atom.idx][0]]
        if bond.order != SINGLE or bond.aromatic:
            continue
        other = mol.atoms[bond.other(atom.idx)]
        if other.symbol == "H":
            continue
        drop.add(atom.idx)
        # bracket-specified neighbors absorb the H into their explicit
        # count; organic-subset neighbors re-infer implicit H after rebuild
        if other.explicit_h >= 0:
            other.explicit_h += 1
    if not drop:
        return mol
    out = Mol()
    remap: Dict[int, int] = {}
    for a in mol.atoms:
        if a.idx in drop:
            continue
        remap[a.idx] = out.add_atom(Atom(
            symbol=a.symbol, aromatic=a.aromatic, charge=a.charge,
            isotope=a.isotope, explicit_h=a.explicit_h, atom_map=a.atom_map,
            chirality=a.chirality))
    for b in mol.bonds:
        if b.a1 in drop or b.a2 in drop:
            continue
        out.add_bond(remap[b.a1], remap[b.a2], b.order, b.aromatic,
                     b.direction)
    # Preserve chirality: the neighbor-order parity must survive the
    # rebuild. A removed H neighbor of a chiral atom keeps its SLOT as the
    # bracket-H marker (the parser's convention for [C@H]); other entries
    # remap to the new indices. Without this the writer serializes the tag
    # against an arbitrary order and enantiomers collapse/flip.
    old_order = getattr(mol, "smiles_neighbor_order", None)
    if old_order is not None:
        new_order: Dict[int, List[int]] = {}
        for a, order in old_order.items():
            if a in drop:
                continue
            entries = []
            for x in order:
                if x == H_MARKER:
                    entries.append(H_MARKER)
                elif x in drop:
                    if mol.atoms[a].chirality != CHI_NONE:
                        entries.append(H_MARKER)
                else:
                    entries.append(remap[x])
            new_order[remap[a]] = entries
        out.smiles_neighbor_order = new_order  # type: ignore[attr-defined]
    out.assign_implicit_h()
    return out


_BRACKET_RE = re.compile(
    r"^(?P<isotope>\d+)?"
    r"(?P<symbol>[A-Z][a-z]?|[a-z]{1,2}|\*)"
    r"(?P<chiral>@{1,2}(?:TH[12]|AL[12]|SP[1-3]|TB\d{1,2}|OH\d{1,2})?)?"
    r"(?P<hcount>H\d*)?"
    r"(?P<charge>\+{1,8}|-{1,8}|\+\d+|-\d+)?"
    r"(?P<map>:\d+)?$"
)


def clear_impossible_stereo(mol: Mol) -> None:
    """Drop tetrahedral tags that cannot denote a stereocenter (role of
    RDKit's sanitize-on-reparse: the reference decode path round-trips every
    candidate through MolFromSmiles(MolToSmiles(...)) — template_decoder.py
    validate_mols/demap — which silently clears tags template application
    left on now-planar atoms, e.g. a carbon that just gained a double bond).

    Conservative RDKit-matching subset: clear when the atom sits on a
    double/triple/aromatic bond (except S/P/Se/As, whose lone-pair centers
    like sulfoxides keep their tag), carries >1 hydrogen, or has a
    neighbor+H count other than 3 or 4. Rank-based duplicate-substituent
    removal is left to the canonicalizer's symmetry handling. In place.
    """
    for atom in mol.atoms:
        if atom.chirality == CHI_NONE:
            continue
        nbrs = len(mol.adj[atom.idx])
        total = nbrs + max(atom.total_h, 0)
        multi = any(mol.bonds[b].order != SINGLE or mol.bonds[b].aromatic
                    for b in mol.adj[atom.idx])
        if ((multi and atom.symbol not in ("S", "P", "Se", "As"))
                or atom.total_h > 1 or total not in (3, 4)):
            atom.chirality = CHI_NONE


def _parse_bracket_atom(body: str) -> Atom:
    m = _BRACKET_RE.match(body)
    if m is None:
        raise SmilesParseError(f"bad bracket atom: [{body}]")
    isotope = int(m.group("isotope")) if m.group("isotope") else 0
    raw_sym = m.group("symbol")
    aromatic = raw_sym[0].islower() and raw_sym != "*"
    symbol = raw_sym if raw_sym == "*" else raw_sym.capitalize()
    if symbol != "*" and symbol not in ATOMIC_NUM:
        raise SmilesParseError(f"unknown element: {raw_sym}")
    chiral = CHI_NONE
    ch = m.group("chiral")
    if ch:
        chiral = CHI_CW if ch.startswith("@@") else CHI_CCW
    hcount = 0
    if m.group("hcount"):
        digits = m.group("hcount")[1:]
        hcount = int(digits) if digits else 1
    charge = 0
    cg = m.group("charge")
    if cg:
        if cg in ("+", "-") or all(c == cg[0] for c in cg):
            charge = len(cg) if cg[0] == "+" else -len(cg)
        else:
            charge = int(cg)
    atom_map = int(m.group("map")[1:]) if m.group("map") else 0
    return Atom(symbol=symbol, aromatic=aromatic, charge=charge, isotope=isotope,
                explicit_h=hcount, atom_map=atom_map, chirality=chiral)


def parse_smiles(smiles: str) -> Mol:
    """Parse a SMILES string into a Mol. Raises SmilesParseError on failure."""
    mol = Mol()
    i = 0
    n = len(smiles)
    prev_atom: Optional[int] = None
    pending_bond: Optional[str] = None
    stack: List[Tuple[Optional[int], Optional[str]]] = []
    ring_open: Dict[int, Tuple[int, Optional[str]]] = {}
    # neighbor order per atom, in SMILES appearance order (for chirality):
    nbr_order: Dict[int, List[int]] = {}

    def close_or_open_ring(num: int, cur: int, bond_char: Optional[str]) -> None:
        if num in ring_open:
            other, open_char = ring_open.pop(num)
            ch = bond_char or open_char
            order, aromatic, direction = _bond_props(ch, other, cur)
            if aromatic is None:
                a_o, a_c = mol.atoms[other], mol.atoms[cur]
                aromatic = a_o.aromatic and a_c.aromatic
                if aromatic:
                    order = SINGLE
            mol.add_bond(other, cur, order, aromatic, direction)
            # For the opening atom the ring bond occupies the slot where the
            # ring digit appeared (replace its placeholder); for the closing
            # atom it occupies the current (appended) slot.
            placeholder = -num - 1
            for k, entry in enumerate(nbr_order[other]):
                if entry == placeholder:
                    nbr_order[other][k] = cur
                    break
            nbr_order[cur].append(other)
        else:
            ring_open[num] = (cur, bond_char)
            nbr_order[cur].append(-num - 1)  # placeholder: filled at closure

    def _bond_props(ch: Optional[str], a1: int, a2: int):
        """Returns (order, aromatic|None, direction). aromatic=None means
        'decide by endpoints' (no explicit bond symbol)."""
        if ch is None:
            return SINGLE, None, 0
        if ch == "/":
            return SINGLE, False, +1
        if ch == "\\":
            return SINGLE, False, -1
        if ch == ":":
            return SINGLE, True, 0
        return _BOND_CHAR[ch], False, 0

    def add_atom_and_bond(atom: Atom) -> int:
        nonlocal prev_atom, pending_bond
        cur = mol.add_atom(atom)
        nbr_order[cur] = []
        if prev_atom is not None:
            order, aromatic, direction = _bond_props(pending_bond, prev_atom, cur)
            if aromatic is None:
                a_p, a_c = mol.atoms[prev_atom], mol.atoms[cur]
                aromatic = a_p.aromatic and a_c.aromatic
                if aromatic:
                    order = SINGLE
            mol.add_bond(prev_atom, cur, order, aromatic, direction)
            nbr_order[prev_atom].append(cur)
            nbr_order[cur].append(prev_atom)
        # A bracket hydrogen on a chiral center occupies the neighbor slot
        # right after the preceding atom (or first, if the atom starts its
        # fragment) in the SMILES chirality convention.
        if atom.chirality != CHI_NONE and atom.explicit_h == 1:
            nbr_order[cur].append(H_MARKER)
        pending_bond = None
        prev_atom = cur
        return cur

    while i < n:
        c = smiles[i]
        if c == "[":
            j = smiles.find("]", i)
            if j < 0:
                raise SmilesParseError(f"unclosed bracket in {smiles!r}")
            add_atom_and_bond(_parse_bracket_atom(smiles[i + 1:j]))
            i = j + 1
        elif c in "BCNOPSFI":
            # two-char organics: Cl, Br
            if c == "C" and i + 1 < n and smiles[i + 1] == "l":
                add_atom_and_bond(Atom("Cl"))
                i += 2
            elif c == "B" and i + 1 < n and smiles[i + 1] == "r":
                add_atom_and_bond(Atom("Br"))
                i += 2
            else:
                add_atom_and_bond(Atom(c))
                i += 1
        elif c in "bcnops":
            add_atom_and_bond(Atom(c.upper(), aromatic=True))
            i += 1
        elif c == "*":
            add_atom_and_bond(Atom("*"))
            i += 1
        elif c in "-=#$:/\\~":
            pending_bond = c
            i += 1
        elif c == "(":
            stack.append((prev_atom, pending_bond))
            pending_bond = None
            i += 1
        elif c == ")":
            if not stack:
                raise SmilesParseError(f"unbalanced ')' in {smiles!r}")
            prev_atom, pending_bond = stack.pop()
            i += 1
        elif c.isdigit():
            if prev_atom is None:
                raise SmilesParseError(f"ring digit before any atom in {smiles!r}")
            close_or_open_ring(int(c), prev_atom, pending_bond)
            pending_bond = None
            i += 1
        elif c == "%":
            if i + 2 >= n or not smiles[i + 1:i + 3].isdigit():
                raise SmilesParseError(f"bad %ring in {smiles!r}")
            close_or_open_ring(int(smiles[i + 1:i + 3]), prev_atom, pending_bond)
            pending_bond = None
            i += 3
        elif c == ".":
            prev_atom = None
            pending_bond = None
            i += 1
        elif c in " \t":
            break  # SMILES ends at whitespace (title field follows)
        else:
            raise SmilesParseError(f"unexpected char {c!r} at {i} in {smiles!r}")

    if ring_open:
        raise SmilesParseError(f"unclosed ring bonds {sorted(ring_open)} in {smiles!r}")
    if stack:
        raise SmilesParseError(f"unclosed branch in {smiles!r}")

    # Keep real neighbors and the chiral-H marker; any leftover ring
    # placeholder would have raised "unclosed ring" above.
    for a, order in nbr_order.items():
        nbr_order[a] = [e for e in order if e >= 0 or e == H_MARKER]

    mol.smiles_neighbor_order = nbr_order  # type: ignore[attr-defined]
    mol.assign_implicit_h()
    # normalize kekulé spellings to aromatic form (RDKit sanitization
    # equivalent) so canonicalization/fingerprints are spelling-invariant
    from .aromatic import perceive_aromaticity
    perceive_aromaticity(mol)
    return mol
