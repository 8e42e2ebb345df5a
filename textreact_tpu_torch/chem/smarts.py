"""SMARTS subset: pattern parsing + subgraph matching on the own Mol graph
(own copy of textreact_tpu/chem/smarts.py).

Covers the query language that rdchiral-lineage retro templates actually use
(reference template_extractor.py emits them; template_decoder.py:179-196
applies them via RDKit): bracket atoms with '!'/'&'/','/';' logic over the
primitives #n, element symbols (case = aromaticity), a/A, * , H<n>, D<n>,
X<n>, charge, R/R<n>, @/@@ (parsed, ignored for matching — RDKit's default
substructure match also ignores chirality), atom maps, plus bare organic
atoms, all bond symbols (default = single-or-aromatic, the SMARTS default),
branches, ring closures, and '.'-separated fragments.

Matching is standard backtracking subgraph isomorphism: pattern atoms in
per-fragment DFS order, every placed pattern bond verified against the
molecule, molecule atoms used at most once across the whole pattern.

Sufficiency note: the TextReact pipeline extracts templates with
use_symbol=True (reference get_templates.py:130-132 ->
get_strict_smarts_for_atom, template_extractor.py:355-375), which emits
bare element+map atoms ('[C:2]', lowercase for aromatic) — a strict subset
of what this module parses. The richer H/D/charge primitives cover
templates from stock rdchiral settings too. Known approximations: R<n>
(membership in n rings) is treated as plain ring membership, and @/@@ in
patterns match any chirality (RDKit's default substructure behavior).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Tuple

from .mol import AROMATIC, ATOMIC_NUM, DOUBLE, Mol, SINGLE, TRIPLE

# bond spec codes
B_DEFAULT, B_SINGLE, B_DOUBLE, B_TRIPLE, B_AROMATIC, B_ANY = range(6)

_BOND_SPEC = {"-": B_SINGLE, "=": B_DOUBLE, "#": B_TRIPLE, ":": B_AROMATIC,
              "~": B_ANY, "/": B_SINGLE, "\\": B_SINGLE}

_AROMATIC_TWO = {"se", "as", "te"}


@dataclasses.dataclass
class _Prim:
    kind: str            # 'elem', 'anum', 'arom', 'aliph', 'any', 'H', 'D',
                         # 'X', 'charge', 'ring', 'chiral'
    value: object = None
    negated: bool = False


@dataclasses.dataclass
class QueryAtom:
    # clauses (AND over ';'): each clause is OR over ',' of AND-lists ('&')
    clauses: List[List[List[_Prim]]]
    atom_map: int = 0
    idx: int = -1


@dataclasses.dataclass
class QueryBond:
    a1: int
    a2: int
    spec: int = B_DEFAULT


class QueryMol:
    def __init__(self) -> None:
        self.atoms: List[QueryAtom] = []
        self.bonds: List[QueryBond] = []
        self.adj: List[List[int]] = []
        self.fragments: List[List[int]] = []  # atom indices per '.'-fragment

    def add_atom(self, atom: QueryAtom) -> int:
        atom.idx = len(self.atoms)
        self.atoms.append(atom)
        self.adj.append([])
        return atom.idx

    def add_bond(self, a1: int, a2: int, spec: int) -> None:
        self.bonds.append(QueryBond(a1, a2, spec))
        b = len(self.bonds) - 1
        self.adj[a1].append(b)
        self.adj[a2].append(b)

    def bond_between(self, a1: int, a2: int) -> Optional[QueryBond]:
        for b in self.adj[a1]:
            q = self.bonds[b]
            if q.a1 + q.a2 - a1 == a2:
                return q
        return None


class SmartsParseError(ValueError):
    pass


_PRIM_RE = re.compile(
    r"(?P<anum>#\d+)|(?P<h>H\d*)|(?P<d>D\d+)|(?P<x>X\d+)"
    r"|(?P<charge>\+\d+|-\d+|\++|-+)|(?P<ringn>R\d+)|(?P<ring>R)"
    r"|(?P<chiral>@@|@)|(?P<any>\*)|(?P<arom>a)|(?P<aliph>A)"
    r"|(?P<elem>[A-Z][a-z]?|[a-z]{1,2})"
)


def _parse_primitives(s: str) -> List[_Prim]:
    """A run of (optionally negated) primitives, e.g. '!#6', 'CH2', 'c'."""
    prims: List[_Prim] = []
    i = 0
    while i < len(s):
        neg = False
        while i < len(s) and s[i] == "!":
            neg = not neg
            i += 1
        # two-letter element symbols first (Al, As, He, Hg, Mn, Sc, ... and
        # aromatic se/as/te): the single-letter a/A/H/D/R primitives would
        # otherwise intercept their first character
        two = s[i:i + 2]
        if len(two) == 2 and (
                (two[0].isupper() and two[1].islower()
                 and two in ATOMIC_NUM)
                or two in _AROMATIC_TWO):
            prims.append(_Prim("elem", (two.capitalize(), two[0].islower()),
                               neg))
            i += 2
            continue
        m = _PRIM_RE.match(s, i)
        if m is None:
            raise SmartsParseError(f"bad SMARTS primitive at {s[i:]!r}")
        i = m.end()
        if m.group("anum"):
            prims.append(_Prim("anum", int(m.group("anum")[1:]), neg))
        elif m.group("h") is not None:
            digits = m.group("h")[1:]
            prims.append(_Prim("H", int(digits) if digits else 1, neg))
        elif m.group("d"):
            prims.append(_Prim("D", int(m.group("d")[1:]), neg))
        elif m.group("x"):
            prims.append(_Prim("X", int(m.group("x")[1:]), neg))
        elif m.group("charge"):
            cg = m.group("charge")
            if cg[0] == "+":
                q = int(cg[1:]) if cg[1:].isdigit() else len(cg)
            else:
                q = -(int(cg[1:]) if cg[1:].isdigit() else len(cg))
            prims.append(_Prim("charge", q, neg))
        elif m.group("ringn") or m.group("ring"):
            prims.append(_Prim("ring", True, neg))
        elif m.group("chiral"):
            prims.append(_Prim("chiral", m.group("chiral"), neg))
        elif m.group("any"):
            prims.append(_Prim("any", None, neg))
        elif m.group("arom"):
            prims.append(_Prim("arom", None, neg))
        elif m.group("aliph"):
            prims.append(_Prim("aliph", None, neg))
        else:
            sym = m.group("elem")
            # two-letter elements were consumed above; a greedy two-char
            # match here is really two one-char primitives
            if len(sym) == 2:
                sym = sym[0]
                i = m.start() + 1
            if sym.capitalize() not in ATOMIC_NUM:
                raise SmartsParseError(f"unknown element {sym!r} in SMARTS")
            aromatic = sym[0].islower()
            prims.append(_Prim("elem", (sym.capitalize(), aromatic), neg))
    return prims


def _parse_bracket(body: str) -> QueryAtom:
    atom_map = 0
    if ":" in body:
        body, map_s = body.rsplit(":", 1)
        if not map_s.isdigit():
            raise SmartsParseError(f"bad atom map in [{body}:{map_s}]")
        atom_map = int(map_s)
    clauses: List[List[List[_Prim]]] = []
    for clause in body.split(";"):
        alternatives: List[List[_Prim]] = []
        for alt in clause.split(","):
            if alt == "":
                continue
            # '&' is explicit high-precedence AND: concatenate primitives
            alternatives.append([p for part in alt.split("&") if part
                                 for p in _parse_primitives(part)])
        if alternatives:
            clauses.append(alternatives)
    return QueryAtom(clauses=clauses, atom_map=atom_map)


def parse_smarts(pattern: str) -> QueryMol:
    """Parse one side of a template (possibly '.'-separated fragments;
    component-grouping parens are stripped — the pattern is matched against
    a single molecule)."""
    q = QueryMol()
    prev: Optional[int] = None
    pending: Optional[str] = None
    stack: List[Tuple[Optional[int], Optional[str]]] = []
    ring_open: Dict[int, Tuple[int, Optional[str]]] = {}
    frag: List[int] = []
    depth = 0
    i, n = 0, len(pattern)

    def new_atom(atom: QueryAtom) -> None:
        nonlocal prev, pending
        cur = q.add_atom(atom)
        frag.append(cur)
        if prev is not None:
            spec = _BOND_SPEC[pending] if pending else B_DEFAULT
            q.add_bond(prev, cur, spec)
        pending = None
        prev = cur

    def close_ring(num: int) -> None:
        nonlocal pending
        if prev is None:
            raise SmartsParseError(f"ring digit before any atom in {pattern!r}")
        if num in ring_open:
            other, och = ring_open.pop(num)
            ch = pending or och
            q.add_bond(other, prev, _BOND_SPEC[ch] if ch else B_DEFAULT)
        else:
            ring_open[num] = (prev, pending)
        pending = None

    while i < n:
        c = pattern[i]
        if c == "[":
            j = pattern.find("]", i)
            if j < 0:
                raise SmartsParseError(f"unclosed bracket in {pattern!r}")
            new_atom(_parse_bracket(pattern[i + 1:j]))
            i = j + 1
        elif c == "(":
            # component-grouping paren (at depth 0 before any atom in the
            # fragment) vs branch paren
            stack.append((prev, pending))
            pending = None
            depth += 1
            i += 1
        elif c == ")":
            if not stack:
                raise SmartsParseError(f"unbalanced ')' in {pattern!r}")
            prev, pending = stack.pop()
            depth -= 1
            i += 1
        elif c in "-=#:~/\\":
            pending = c
            i += 1
        elif c == ".":
            if frag:
                q.fragments.append(list(frag))
                frag.clear()
            prev = None
            pending = None
            i += 1
        elif c.isdigit():
            close_ring(int(c))
            i += 1
        elif c == "%":
            if i + 2 >= n or not pattern[i + 1:i + 3].isdigit():
                raise SmartsParseError(f"bad %ring closure in {pattern!r}")
            close_ring(int(pattern[i + 1:i + 3]))
            i += 3
        elif c == "*":
            new_atom(QueryAtom(clauses=[[[_Prim("any")]]]))
            i += 1
        else:
            # bare atom: Cl/Br or single letter (case = aromaticity)
            two = pattern[i:i + 2]
            if two in ("Cl", "Br"):
                new_atom(QueryAtom(clauses=[[[_Prim("elem", (two, False))]]]))
                i += 2
            elif c.isalpha():
                new_atom(QueryAtom(
                    clauses=[[[_Prim("elem", (c.capitalize(), c.islower()))]]]))
                i += 1
            else:
                raise SmartsParseError(f"unexpected {c!r} in {pattern!r}")
    if ring_open:
        raise SmartsParseError(f"unclosed SMARTS rings in {pattern!r}")
    if stack:
        raise SmartsParseError(f"unclosed branch '(' in {pattern!r}")
    if frag:
        q.fragments.append(list(frag))
    return q


# --------------------------------------------------------------------------
# matching
# --------------------------------------------------------------------------

def ring_membership(mol: Mol) -> Tuple[List[bool], List[bool]]:
    """(atom_in_ring, bond_in_ring), exact for rings of ANY size: a bond is
    in a ring iff it is not a bridge (iterative Tarjan low-link), an atom iff
    it has a non-bridge bond. O(V+E), matching RDKit IsInRing semantics."""
    n = len(mol.atoms)
    in_ring_bond = [False] * len(mol.bonds)
    disc = [-1] * n
    low = [0] * n
    timer = 0
    for root in range(n):
        if disc[root] != -1:
            continue
        # iterative DFS: stack of (atom, parent_bond, adjacency iterator idx)
        stack = [(root, -1, 0)]
        disc[root] = low[root] = timer
        timer += 1
        while stack:
            a, pbond, it = stack[-1]
            if it < len(mol.adj[a]):
                stack[-1] = (a, pbond, it + 1)
                bidx = mol.adj[a][it]
                if bidx == pbond:
                    continue
                o = mol.bonds[bidx].a1 + mol.bonds[bidx].a2 - a
                if disc[o] == -1:
                    disc[o] = low[o] = timer
                    timer += 1
                    stack.append((o, bidx, 0))
                else:
                    # back edge: part of a cycle
                    in_ring_bond[bidx] = True
                    low[a] = min(low[a], disc[o])
            else:
                stack.pop()
                if stack:
                    parent = stack[-1][0]
                    low[parent] = min(low[parent], low[a])
                    if low[a] > disc[parent]:
                        pass  # bridge: pbond stays False
                    elif pbond >= 0:
                        in_ring_bond[pbond] = True
    in_ring_atom = [False] * n
    for bidx, flag in enumerate(in_ring_bond):
        if flag:
            in_ring_atom[mol.bonds[bidx].a1] = True
            in_ring_atom[mol.bonds[bidx].a2] = True
    return in_ring_atom, in_ring_bond


def _prim_matches(p: _Prim, mol: Mol, idx: int, in_ring: List[bool]) -> bool:
    atom = mol.atoms[idx]
    if p.kind == "any":
        ok = True
    elif p.kind == "elem":
        sym, aromatic = p.value
        ok = atom.symbol == sym and atom.aromatic == aromatic
    elif p.kind == "anum":
        ok = ATOMIC_NUM.get(atom.symbol, 0) == p.value
    elif p.kind == "arom":
        ok = atom.aromatic
    elif p.kind == "aliph":
        ok = not atom.aromatic
    elif p.kind == "H":
        ok = atom.total_h == p.value
    elif p.kind == "D":
        ok = mol.degree(idx) == p.value
    elif p.kind == "X":
        ok = mol.degree(idx) + atom.total_h == p.value
    elif p.kind == "charge":
        ok = atom.charge == p.value
    elif p.kind == "ring":
        ok = in_ring[idx]
    elif p.kind == "chiral":
        ok = True  # chirality not constrained in substructure match
    else:
        ok = False
    return not ok if p.negated else ok


def atom_matches(q: QueryAtom, mol: Mol, idx: int, in_ring: List[bool]) -> bool:
    for clause in q.clauses:
        if not any(all(_prim_matches(p, mol, idx, in_ring) for p in alt)
                   for alt in clause):
            return False
    return True


def _bond_matches(spec: int, bond) -> bool:
    if spec == B_ANY:
        return True
    if spec == B_DEFAULT:
        return bond.aromatic or bond.order == SINGLE
    if spec == B_AROMATIC:
        return bond.aromatic
    if spec == B_SINGLE:
        return bond.order == SINGLE and not bond.aromatic
    if spec == B_DOUBLE:
        return bond.order == DOUBLE and not bond.aromatic
    if spec == B_TRIPLE:
        return bond.order == TRIPLE
    return False


def find_matches(query: QueryMol, mol: Mol,
                 max_matches: int = 256) -> List[Dict[int, int]]:
    """All embeddings {query atom idx -> mol atom idx}, molecule atoms used
    once across the whole (possibly multi-fragment) pattern."""
    in_ring, _ = ring_membership(mol)
    fragments = query.fragments or [list(range(len(query.atoms)))]

    # per-fragment DFS visit order (connected patterns)
    orders: List[List[int]] = []
    for frag in fragments:
        frag_set = set(frag)
        order: List[int] = []
        seen = set()
        stack = [frag[0]]
        while stack:
            a = stack.pop()
            if a in seen:
                continue
            seen.add(a)
            order.append(a)
            for b in query.adj[a]:
                o = query.bonds[b].a1 + query.bonds[b].a2 - a
                if o in frag_set and o not in seen:
                    stack.append(o)
        if len(order) != len(frag):  # disconnected within a fragment
            order += [a for a in frag if a not in seen]
        orders.append(order)

    flat_order = [a for order in orders for a in order]
    results: List[Dict[int, int]] = []
    assignment: Dict[int, int] = {}
    used = set()

    def place(pos: int) -> None:
        if len(results) >= max_matches:
            return
        if pos == len(flat_order):
            results.append(dict(assignment))
            return
        qa = flat_order[pos]
        # candidate mol atoms: neighbors of an already-placed pattern
        # neighbor, else all atoms
        anchors = []
        for b in query.adj[qa]:
            o = query.bonds[b].a1 + query.bonds[b].a2 - qa
            if o in assignment:
                anchors.append((o, query.bonds[b]))
        if anchors:
            o0, qb0 = anchors[0]
            candidates = mol.neighbors(assignment[o0])
        else:
            candidates = range(len(mol.atoms))
        for m in candidates:
            if m in used:
                continue
            if not atom_matches(query.atoms[qa], mol, m, in_ring):
                continue
            ok = True
            for o, qb in anchors:
                mb = mol.bond_between(assignment[o], m)
                if mb is None or not _bond_matches(qb.spec, mb):
                    ok = False
                    break
            if not ok:
                continue
            assignment[qa] = m
            used.add(m)
            place(pos + 1)
            del assignment[qa]
            used.discard(m)

    place(0)
    return results
