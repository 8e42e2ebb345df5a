"""Edit-site labeling on the own chem kit (RDKit-free engine; own copy of
textreact_tpu/templates/native_labeling.py).

Native twin of labeling.py with identical semantics over chem.mol.Mol
(reference preprocess/template_extraction/template_extract_utils.py:74-340):
classify each changed atom/bond as a leaving-group attachment (A), broken
bond (B), changed bond (C) or remote participant (R); map atom-map numbers
to atom indices and renumbered template positions; record per-atom
H/charge/chirality deltas. Input invariant (established by the extractor's
clean_map_and_sort step, template_extractor.py:523-525): every atom map in
`edit_maps` is present on BOTH sides of the reaction.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

from ..chem.mol import AROMATIC, DOUBLE, Mol, SINGLE, TRIPLE, parse_smiles
from .labeling import _atoms_to_positions, _bonds_to_positions

_ORDER_SYM = {SINGLE: "-", DOUBLE: "=", TRIPLE: "#"}


def _bond_desc(mol: Mol, bond) -> str:
    """Order-independent bond descriptor incl. endpoint map numbers
    (native twin of labeling._bond_desc / reference check_bond_change)."""
    ends = []
    for idx in (bond.a1, bond.a2):
        a = mol.atoms[idx]
        label = str(a.atomic_num)
        if a.atom_map:
            label += str(a.atom_map)
        ends.append(label)
    ends.sort()
    sym = "@" if bond.aromatic else _ORDER_SYM.get(bond.order, "-")
    return f"{ends[0]}{sym}{ends[1]}"


def _map_to_idx(mol: Mol) -> Dict[int, int]:
    return {a.atom_map: a.idx for a in mol.atoms}


def _bond_changed(mol1: Mol, b1, mol2: Mol, b2) -> bool:
    return (b1 is not None and b2 is not None
            and _bond_desc(mol1, b1) != _bond_desc(mol2, b2))


def label_retro_edit_sites(product_smiles: str, reactant_smiles: str,
                           edit_maps: Sequence[int]):
    """(grow atoms, broken bonds, changed bonds, remote atoms) over atom-map
    numbers (reference label_retro_edit_site,
    template_extract_utils.py:74-131)."""
    edit_maps = [int(m) for m in edit_maps]
    pmol = parse_smiles(product_smiles)
    rmol = parse_smiles(reactant_smiles)
    pmap, rmap = _map_to_idx(pmol), _map_to_idx(rmol)
    used: Set[int] = set()
    grow_atoms: List[int] = []
    broken_bonds: List[Tuple[int, int]] = []
    changed_bonds: List[Tuple[int, int]] = []

    for a in edit_maps:
        for b in edit_maps:
            if a >= b:
                continue
            pb = pmol.bond_between(pmap[a], pmap[b])
            rb = rmol.bond_between(rmap[a], rmap[b])
            if pb is not None and rb is None:  # bond broken in retro
                broken_bonds.append((a, b))
                used.update((a, b))

    for a in edit_maps:
        if a in used:
            continue
        p_nbrs = sorted(pmol.atoms[n].atom_map
                        for n in pmol.neighbors(pmap[a]))
        r_nbrs = sorted(rmol.atoms[n].atom_map
                        for n in rmol.neighbors(rmap[a]))
        if p_nbrs != r_nbrs:  # leaving group attaches here
            used.add(a)
            grow_atoms.append(a)

    for a in edit_maps:
        for b in edit_maps:
            if a >= b:
                continue
            pb = pmol.bond_between(pmap[a], pmap[b])
            rb = rmol.bond_between(rmap[a], rmap[b])
            if _bond_changed(pmol, pb, rmol, rb) \
                    and a not in used and b not in used:
                changed_bonds.append((a, b))
                changed_bonds.append((b, a))

    involved = set(grow_atoms) | {x for bond in broken_bonds + changed_bonds
                                  for x in bond}
    remote: List[int] = []
    for a in edit_maps:
        if a in involved:
            continue
        nbr_maps = [rmol.atoms[n].atom_map for n in rmol.neighbors(rmap[a])]
        if any(b in nbr_maps for b in involved):
            continue
        # one remote entry per neighbor (reference weights by degree,
        # template_extract_utils.py:121-130)
        remote.extend(a for _ in nbr_maps)
    return grow_atoms, broken_bonds, changed_bonds, remote


def label_forward_edit_sites(reactant_smiles: str, product_smiles: str,
                             edit_maps: Sequence[int]):
    """Forward-synthesis labeling (reference label_foward_edit_site,
    template_extract_utils.py:133-244)."""
    edit_maps = [int(m) for m in edit_maps]
    rmol = parse_smiles(reactant_smiles)
    pmol = parse_smiles(product_smiles)
    rmap, pmap = _map_to_idx(rmol), _map_to_idx(pmol)

    def pbond(a, b):
        if a not in pmap or b not in pmap:
            return None
        return pmol.bond_between(pmap[a], pmap[b])

    formed, broken, changed = [], [], []
    acceptors1: Set[int] = set()
    acceptors2: Set[int] = set()
    symmetric = True

    for a in edit_maps:
        for b in edit_maps:
            if a >= b:
                continue
            pb, rb = pbond(a, b), rmol.bond_between(rmap[a], rmap[b])
            if rb is not None and pb is None:
                if a in pmap:
                    broken.append((a, b))
                    acceptors1.add(a)
                if b in pmap:
                    broken.append((b, a))
                    acceptors1.add(b)

    for a in edit_maps:
        for b in edit_maps:
            if a >= b:
                continue
            pb, rb = pbond(a, b), rmol.bond_between(rmap[a], rmap[b])
            if pb is not None and rb is not None \
                    and _bond_desc(pmol, pb) != _bond_desc(rmol, rb):
                changed.append((a, b))
                changed.append((b, a))
                acceptors2.update((a, b))

    for a in edit_maps:
        for b in edit_maps:
            if a >= b:
                continue
            pb, rb = pbond(a, b), rmol.bond_between(rmap[a], rmap[b])
            if rb is None and pb is not None:
                in1 = (a in acceptors1, b in acceptors1)
                in2 = (a in acceptors2, b in acceptors2)
                if not any(in1) and not any(in2):
                    formed.append((a, b))
                    formed.append((b, a))
                elif all(in1):
                    symmetric = False
                    formed.append((a, b))
                    formed.append((b, a))
                else:
                    symmetric = False
                    if in1[0]:
                        formed.append((b, a))
                    elif in2[0] and not in1[1]:
                        formed.append((b, a))
                    if in1[1]:
                        formed.append((a, b))
                    elif in2[1] and not in1[0]:
                        formed.append((a, b))

    if not symmetric:
        new_changed = []
        acceptors = {bond[1] for bond in formed} | acceptors1
        for atom in acceptors:
            new_changed.extend(b for b in changed if b[0] == atom)
        donors = {bond[0] for bond in formed}
        for atom in donors:
            new_changed.extend(b for b in changed if b[1] == atom)
        changed = list(set(new_changed))

    involved = {x for bond in formed + broken + changed for x in bond}
    remote_bonds = []
    for a in edit_maps:
        if a in involved:
            continue
        nbr_maps = [rmol.atoms[n].atom_map for n in rmol.neighbors(rmap[a])]
        if any(b in nbr_maps for b in involved):
            continue
        remote_bonds.extend((a, n) for n in nbr_maps)
    return formed, broken, changed, remote_bonds


def chs_changes(smiles1: str, smiles2: str, edit_maps: Sequence[int],
                replacement: Dict[int, int], use_stereo: bool):
    """Per-template-position H/charge/chirality deltas (reference
    label_CHS_change, template_extract_utils.py:246-270). Explicit-H counts
    follow RDKit GetNumExplicitHs semantics: the bracket-specified count,
    0 for unbracketed atoms."""
    mol1, mol2 = parse_smiles(smiles1), parse_smiles(smiles2)
    map1, map2 = _map_to_idx(mol1), _map_to_idx(mol2)

    def explicit_h(atom) -> int:
        return atom.explicit_h if atom.explicit_h >= 0 else 0

    h, c, s = {}, {}, {}
    for m in (int(x) for x in edit_maps):
        if m not in map2:
            continue
        a1 = mol1.atoms[map1[m]]
        a2 = mol2.atoms[map2[m]]
        h[replacement[m]] = explicit_h(a2) - explicit_h(a1)
        c[replacement[m]] = a2.charge - a1.charge
        s1, s2 = a1.chirality, a2.chirality  # same ints as labeling.CHIRAL_INT
        s[replacement[m]] = 0 if (s2 == s1 or not use_stereo) else s2
    return map1, h, c, s


def match_label(reactants: str, products: str, replacement_dict: Dict,
                edit_maps: Sequence[str], retro: bool = True,
                remote: bool = True, use_stereo: bool = True):
    """Full labeling of one extracted reaction (reference match_label,
    template_extract_utils.py:301-326), native engine."""
    smiles1, smiles2 = (products, reactants) if retro else (reactants, products)
    replacement = {int(k): int(v) for k, v in replacement_dict.items()}
    idx_of, h_change, charge_change, chiral_change = chs_changes(
        smiles1, smiles2, edit_maps, replacement, use_stereo)
    if retro:
        grow, broken, changed, remote_atoms = label_retro_edit_sites(
            smiles1, smiles2, edit_maps)
        edits = {"A": _atoms_to_positions(grow, idx_of, replacement),
                 "B": _bonds_to_positions(broken, idx_of, replacement, True),
                 "C": _bonds_to_positions(changed, idx_of, replacement)}
        if remote:
            edits["R"] = _atoms_to_positions(remote_atoms, idx_of, replacement)
    else:
        formed, broken, changed, remote_bonds = label_forward_edit_sites(
            smiles1, smiles2, edit_maps)
        edits = {"A": _bonds_to_positions(formed, idx_of, replacement),
                 "B": _bonds_to_positions(broken, idx_of, replacement),
                 "C": _bonds_to_positions(changed, idx_of, replacement)}
        if remote:
            edits["R"] = _bonds_to_positions(remote_bonds, idx_of, replacement,
                                             False, True)
    return edits, h_change, charge_change, chiral_change


def bonds_from_smiles(smiles: str) -> Set[Tuple[int, int]]:
    """All directed bonded atom-index pairs (reference get_bonds_from_smiles,
    template_extract_utils.py:328-340), native engine."""
    mol = parse_smiles(smiles)
    out: Set[Tuple[int, int]] = set()
    for atom in mol.atoms:
        for other in mol.neighbors(atom.idx):
            out.add((atom.idx, other))
    return out
