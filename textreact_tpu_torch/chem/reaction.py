"""Template application on the own Mol graph (RDKit RunReactants role; own
copy of textreact_tpu/chem/reaction.py).

The reference decodes template-based retro predictions by running the
predicted rdchiral template on the product with RDKit and patching
H/charge/chirality from the template info (reference
template_decoder.py:179-196, 115-142). Where RDKit is absent, this
module implements the needed reaction semantics natively on chem.Mol:

- match the template's LHS (product-side) pattern with chem.smarts;
- copy the product graph, freezing every atom's H count (edits must not
  silently shift implicit-H inference);
- delete product bonds between mapped atom pairs that are bonded in the
  LHS (only the matched chemistry is rewritten; unmatched product context
  stays attached to its mapped neighbors);
- build the RHS: mapped atoms are transformed in place (element case sets
  the aromatic flag; H/charge specs apply when present), unmapped RHS atoms
  are created, RHS bonds added with their specified orders (default =
  aromatic when both ends are aromatic, else single);
- mapped LHS atoms missing from the RHS, and unmapped LHS atoms, are
  deleted with their bonds;
- aromatic flags outside rings are cleared (reference fix_aromatic,
  template_decoder.py:98-107) and a light valence sanity check stands in
  for RDKit's sanitization round-trip.

Each match yields the rewritten graph plus {atom map -> product atom idx}
bookkeeping (RDKit's old_mapno/react_atom_idx), which the decoder uses to
verify the predicted edit site and to patch H/charge/chirality.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .mol import (AROMATIC, Atom, Bond, DEFAULT_VALENCES, DOUBLE, Mol,
                  SINGLE, TRIPLE)
from .smarts import (B_ANY, B_AROMATIC, B_DEFAULT, B_DOUBLE, B_SINGLE,
                     B_TRIPLE, QueryMol, _Prim, find_matches, parse_smarts,
                     ring_membership)


@dataclasses.dataclass
class AppliedTemplate:
    mol: Mol                          # rewritten (possibly multi-fragment)
    map_to_product: Dict[int, int]    # atom map -> PRODUCT atom idx
    map_to_new: Dict[int, int]        # atom map -> rewritten atom idx
    new_to_product: Dict[int, int]    # rewritten atom idx -> product idx


def _spec_info(qatom) -> Dict[str, object]:
    """Definite properties asserted by an RHS query atom: element+aromatic,
    H count, charge (positively stated, unnegated, no alternatives)."""
    info: Dict[str, object] = {}
    for clause in qatom.clauses:
        if len(clause) != 1:
            continue  # OR alternatives are not definite
        for p in clause[0]:
            if p.negated:
                continue
            if p.kind == "elem":
                info["symbol"], info["aromatic"] = p.value
            elif p.kind == "anum":
                from .mol import ATOMIC_NUM
                for sym, num in ATOMIC_NUM.items():
                    if num == p.value:
                        info.setdefault("symbol", sym)
                        break
                # NOTE: #n asserts nothing about aromaticity
            elif p.kind == "arom":
                info["aromatic"] = True
            elif p.kind == "aliph":
                info["aromatic"] = False
            elif p.kind == "H":
                info["h"] = p.value
            elif p.kind == "charge":
                info["charge"] = p.value
            elif p.kind == "chiral":
                info["chiral"] = p.value
    return info


def _copy_mol_frozen_h(mol: Mol) -> Mol:
    out = Mol()
    for a in mol.atoms:
        out.add_atom(Atom(symbol=a.symbol, aromatic=a.aromatic,
                          charge=a.charge, isotope=a.isotope,
                          explicit_h=a.total_h, atom_map=a.atom_map,
                          chirality=a.chirality))
    for b in mol.bonds:
        out.add_bond(b.a1, b.a2, b.order, b.aromatic, b.direction)
    out.assign_implicit_h()
    return out


def _rhs_bond(spec: int, arom_a: bool, arom_b: bool) -> Tuple[int, bool]:
    if spec == B_AROMATIC:
        return SINGLE, True
    if spec == B_DOUBLE:
        return DOUBLE, False
    if spec == B_TRIPLE:
        return TRIPLE, False
    if spec in (B_DEFAULT, B_ANY):
        if arom_a and arom_b:
            return SINGLE, True
        return SINGLE, False
    return SINGLE, False


def _remove_atoms(mol: Mol, drop: set) -> Tuple[Mol, Dict[int, int]]:
    """Rebuild without `drop` atoms; returns (new mol, old->new index)."""
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
    out.assign_implicit_h()
    return out, remap


def fix_nonring_aromatic(mol: Mol) -> None:
    """Clear aromatic flags outside rings (reference fix_aromatic)."""
    in_ring_atom, in_ring_bond = ring_membership(mol)
    for a in mol.atoms:
        if a.aromatic and not in_ring_atom[a.idx]:
            a.aromatic = False
    for bi, b in enumerate(mol.bonds):
        if b.aromatic and not in_ring_bond[bi]:
            b.aromatic = False
            b.order = SINGLE


def valence_ok(mol: Mol) -> bool:
    """Light stand-in for RDKit sanitization: neutral organic-subset atoms
    must not exceed their maximum standard valence."""
    for a in mol.atoms:
        if a.charge != 0 or a.symbol not in DEFAULT_VALENCES:
            continue
        order_sum = 0
        has_plain_multi = False
        for bidx in mol.adj[a.idx]:
            b = mol.bonds[bidx]
            order_sum += 1 if b.aromatic else b.order
            if not b.aromatic and b.order >= DOUBLE:
                has_plain_multi = True
        # the delocalized aromatic π counts only when the atom's π electron
        # is not already in an explicit multiple bond (2-pyridone-type
        # c(=O) ring carbons)
        if (a.aromatic and a.symbol in ("B", "C", "N", "P")
                and not has_plain_multi):
            order_sum += 1
        if order_sum + a.total_h > max(DEFAULT_VALENCES[a.symbol]):
            return False
    return True


def run_retro_template(product: Mol, template: str,
                       max_matches: int = 1000,
                       check_valence: bool = True) -> List[AppliedTemplate]:
    """Apply `lhs>>rhs` to the product; one AppliedTemplate per LHS match.

    With check_valence (default), rewrites that violate standard valences
    are dropped. Decoders that patch H counts afterwards (template
    change_H deltas, reference fix_reactant_atoms) must pass
    check_valence=False and validate after patching — RDKit's RunReactants
    likewise defers sanitization, so e.g. a hydrogenation template C-C>>C=C
    transiently over-valences until the H patch lands."""
    lhs_s, rhs_s = template.split(">>")
    lhs = parse_smarts(lhs_s)
    rhs = parse_smarts(rhs_s)

    lhs_maps = {qa.atom_map: qa.idx for qa in lhs.atoms if qa.atom_map}
    rhs_maps = {qa.atom_map: qa.idx for qa in rhs.atoms if qa.atom_map}

    # RHS atoms without an LHS counterpart must be creatable (definite
    # element). This depends only on the parsed template, not on the match,
    # so it is checked once up front.
    for qa in rhs.atoms:
        if qa.atom_map and qa.atom_map in lhs_maps:
            continue
        if "symbol" not in _spec_info(qa):
            return []  # un-creatable wildcard product atom

    results: List[AppliedTemplate] = []
    for match in find_matches(lhs, product, max_matches=max_matches):
        mol = _copy_mol_frozen_h(product)
        map_to_product = {m: match[qi] for m, qi in lhs_maps.items()}

        # 1. delete product bonds replicated in the LHS between mapped atoms
        drop_bonds = set()
        for qb in lhs.bonds:
            a, b = match[qb.a1], match[qb.a2]
            for bidx in mol.adj[a]:
                if mol.bonds[bidx].a1 + mol.bonds[bidx].a2 - a == b:
                    drop_bonds.add(bidx)

        # 2. transform mapped atoms per RHS specs
        for m, qi in rhs_maps.items():
            if m not in map_to_product:
                continue
            target = mol.atoms[map_to_product[m]]
            info = _spec_info(rhs.atoms[qi])
            if "symbol" in info:
                target.symbol = info["symbol"]          # type: ignore
            if "aromatic" in info:
                # only a DEFINITE aromaticity assertion (element case or
                # a/A primitive) changes the flag — [#6:1] keeps the
                # product atom's aromaticity, as RunReactants does
                target.aromatic = bool(info["aromatic"])
            if "h" in info:
                target.explicit_h = int(info["h"])      # type: ignore
            if "charge" in info:
                target.charge = int(info["charge"])     # type: ignore

        # 3. create unmapped RHS atoms
        rhs_to_new: Dict[int, int] = {}
        for qa in rhs.atoms:
            if qa.atom_map and qa.atom_map in map_to_product:
                rhs_to_new[qa.idx] = map_to_product[qa.atom_map]
                continue
            info = _spec_info(qa)
            rhs_to_new[qa.idx] = mol.add_atom(Atom(
                symbol=str(info["symbol"]),
                aromatic=bool(info.get("aromatic", False)),
                charge=int(info.get("charge", 0)),
                explicit_h=int(info["h"]) if "h" in info else -1))

        # 4. RHS bonds between rewritten atoms (replacing dropped ones)
        existing = {}
        for bidx, b in enumerate(mol.bonds):
            existing[(min(b.a1, b.a2), max(b.a1, b.a2))] = bidx
        for qb in rhs.bonds:
            a = rhs_to_new[qb.a1]
            b = rhs_to_new[qb.a2]
            order, arom = _rhs_bond(qb.spec, mol.atoms[a].aromatic,
                                    mol.atoms[b].aromatic)
            key = (min(a, b), max(a, b))
            if key in existing and existing[key] not in drop_bonds:
                bond = mol.bonds[existing[key]]
                bond.order, bond.aromatic = order, arom
            elif key in existing and existing[key] in drop_bonds:
                drop_bonds.discard(existing[key])
                bond = mol.bonds[existing[key]]
                bond.order, bond.aromatic, bond.direction = order, arom, 0
            else:
                mol.add_bond(a, b, order, arom)

        # 5. delete LHS atoms absent from the RHS (mapped-but-dropped and
        #    unmapped query atoms)
        drop_atoms = set()
        for m, qi in lhs_maps.items():
            if m not in rhs_maps:
                drop_atoms.add(match[qi])
        for qa in lhs.atoms:
            if not qa.atom_map:
                drop_atoms.add(match[qa.idx])

        # rebuild without dropped bonds first
        if drop_bonds:
            keep = Mol()
            for a in mol.atoms:
                keep.add_atom(Atom(symbol=a.symbol, aromatic=a.aromatic,
                                   charge=a.charge, isotope=a.isotope,
                                   explicit_h=a.explicit_h,
                                   atom_map=a.atom_map,
                                   chirality=a.chirality))
            for bidx, b in enumerate(mol.bonds):
                if bidx not in drop_bonds:
                    keep.add_bond(b.a1, b.a2, b.order, b.aromatic,
                                  b.direction)
            mol = keep
        mol.assign_implicit_h()
        mol, remap = _remove_atoms(mol, drop_atoms)
        new_map_to_product = {}
        map_to_new = {}
        new_to_product = {}
        for m, pidx in map_to_product.items():
            if pidx in remap:
                new_map_to_product[m] = pidx  # product idx (stable)
                map_to_new[m] = remap[pidx]
        for old, new in remap.items():
            if old < len(product.atoms):
                new_to_product[new] = old

        fix_nonring_aromatic(mol)
        if check_valence and not valence_ok(mol):
            continue
        results.append(AppliedTemplate(mol=mol,
                                       map_to_product=new_map_to_product,
                                       map_to_new=map_to_new,
                                       new_to_product=new_to_product))
    return results


def mol_fragments_smiles(mol: Mol, clear_maps: bool = True) -> Optional[str]:
    """'.'-sorted canonical SMILES of the fragments (reference demap,
    template_decoder.py:144-156); None when the rewrite does not
    round-trip through the parser."""
    from .canon import canonical_ranks, canonical_smiles_strict, write_smiles
    if clear_maps:
        for a in mol.atoms:
            a.atom_map = 0
    try:
        ranks = canonical_ranks(mol)
        frags = [write_smiles(mol, rank_of=ranks, atom_subset=frag)
                 for frag in mol.fragment_atom_sets()]
        smiles = ".".join(sorted(frags))
        return canonical_smiles_strict(smiles)
    except Exception:
        return None
