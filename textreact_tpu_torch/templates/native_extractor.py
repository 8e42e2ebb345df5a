"""Retro template extraction on the own chem kit (RDKit-free engine; own
copy of textreact_tpu/templates/native_extractor.py, the port's one
extraction engine).

Implements the rdchiral-lineage pipeline the reference vendors (reference
preprocess/template_extraction/template_extractor.py:517-626) over chem.mol
/ chem.canon / chem.smarts instead of RDKit: split reagents, demap
non-product atom maps, detect changed atoms, cut strict SMARTS fragments
(leaving groups fully included on the reactant side), canonicalize the
transform with smarts_canon, and label edit sites with native_labeling.

Template strings produced by this engine are written by the own canonical
writer, so they differ byte-wise from an RDKit engine's strings (different
canonical traversal) — but they carry the same semantics and round-trip
through the own reaction engine (chem/reaction.py): a template extracted
from a reaction re-applies to that reaction's product and yields its
reactants.

Known divergences from an RDKit engine, by design:
- explicit hydrogen atoms are emitted as ``[#1]`` (RDKit writes ``[H]``,
  which this kit's SMARTS parser would read as an H-count primitive);
- radical-electron changes are not detected (the own Mol has no radicals;
  mapped USPTO reactions do not carry them);
- fragment-internal atom order follows the own canonical ranks.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from ..chem.canon import canonical_ranks, write_smiles
from ..chem.mol import (CHI_CCW, CHI_CW, CHI_NONE, Mol, SmilesParseError,
                        parse_smiles, remove_explicit_hydrogens)
from ..chem.smarts import SmartsParseError, parse_smarts
from . import native_labeling
from .smarts_canon import reassign_atom_maps, reorder_sides

DEFAULT_SETTINGS = {
    "verbose": False, "use_stereo": True, "use_symbol": True,
    "max_unmap": 5, "retro": True, "remote": True, "least_atom_num": 2,
}


# ---------------------------------------------------------------------------
# canonical (re)writing helpers
# ---------------------------------------------------------------------------

def mol_to_mapped_smiles(mol: Mol) -> str:
    """Canonical SMILES retaining atom maps (role of Chem.MolToSmiles on a
    mapped mol; fragments sorted for determinism)."""
    ranks = canonical_ranks(mol)
    frags = [write_smiles(mol, rank_of=ranks, atom_subset=f)
             for f in mol.fragment_atom_sets()]
    return ".".join(sorted(frags))


def demapped_canonical(mol: Mol) -> str:
    """Canonical SMILES with every atom map cleared (non-mutating)."""
    saved = [a.atom_map for a in mol.atoms]
    for a in mol.atoms:
        a.atom_map = 0
    try:
        return mol_to_mapped_smiles(mol)
    finally:
        for a, m in zip(mol.atoms, saved):
            a.atom_map = m


def _num_atoms(smiles: str) -> int:
    return len(parse_smiles(smiles).atoms)


# ---------------------------------------------------------------------------
# reaction preparation (reference split_reagents / clean_map_and_sort)
# ---------------------------------------------------------------------------

def _replace_deuterated(smiles: str) -> str:
    return re.sub(r"\[2H\]", "[H]", smiles)


def split_reagents(reactant_str: str, product_str: str, least_atom_num: int
                   ) -> Tuple[List[str], List[str], List[str]]:
    """Drop trivial product fragments and move shared fragments to reagents
    (reference split_reagents, template_extractor.py:510-515)."""
    rs = _replace_deuterated(reactant_str).split(".")
    ps = _replace_deuterated(product_str).split(".")
    candidates = [_num_atoms(s) for s in ps if s not in rs]
    least = min(max(candidates), least_atom_num) if candidates else least_atom_num
    ps = [s for s in ps if _num_atoms(s) >= least]
    reagents = [s for s in rs if s in ps]
    return ([r for r in rs if r not in reagents],
            [p for p in ps if p not in reagents], reagents)


def demap_except(smiles_list: Sequence[str], keep_maps) -> List[Mol]:
    """Strip atom maps not in keep_maps, re-canonicalize, sort by size desc
    (reference clean_map_and_sort, template_extractor.py:29-40)."""
    mols = []
    for smiles in smiles_list:
        if not smiles:
            continue
        mol = parse_smiles(smiles)
        for a in mol.atoms:
            if a.atom_map not in keep_maps:
                a.atom_map = 0
        mols.append(parse_smiles(mol_to_mapped_smiles(mol)))
    return sorted(mols, key=lambda m: len(m.atoms), reverse=True)


# ---------------------------------------------------------------------------
# changed-atom detection (reference get_changed_atoms / atoms_are_different)
# ---------------------------------------------------------------------------

_ORDER_SYM = {1: "-", 2: "=", 3: "#", 4: "$"}


def _bond_signature(mol: Mol, bond) -> str:
    """Order-independent bond descriptor incl. endpoint map numbers
    (reference bond_to_smarts, template_extractor.py:467-481)."""
    ends = []
    for idx in (bond.a1, bond.a2):
        a = mol.atoms[idx]
        label = str(a.atomic_num)
        if a.atom_map:
            label += str(a.atom_map)
        ends.append(label)
    ends.sort()
    sym = ":" if bond.aromatic else _ORDER_SYM.get(bond.order, "-")
    return f"{ends[0]}{sym}{ends[1]}"


def _neighbor_maps(mol: Mol, idx: int) -> List[int]:
    return sorted(mol.atoms[n].atom_map for n in mol.neighbors(idx))


def _atom_changed(pmol: Mol, pidx: int, rmol: Mol, ridx: int,
                  remote: bool) -> bool:
    """Local-environment difference test (reference atoms_are_different,
    template_extractor.py:71-90; radicals are out of the own Mol's model)."""
    patom, ratom = pmol.atoms[pidx], rmol.atoms[ridx]
    if patom.atomic_num != ratom.atomic_num:
        return True
    if remote:
        if patom.charge != ratom.charge:
            return True
        if patom.total_h != ratom.total_h:
            return True
    if _neighbor_maps(pmol, pidx) != _neighbor_maps(rmol, ridx):
        return True
    bonds1 = sorted(_bond_signature(pmol, pmol.bonds[b])
                    for b in pmol.adj[pidx])
    bonds2 = sorted(_bond_signature(rmol, rmol.bonds[b])
                    for b in rmol.adj[ridx])
    return bonds1 != bonds2


def changed_atoms(reactants: Sequence[Mol], products: Sequence[Mol],
                  remote: bool = True):
    """Mapped atoms whose environment differs between sides
    (reference get_changed_atoms, template_extractor.py:145-196). Returns
    (reactant-side Atom refs, tags as strings). After detection, isotope
    labels are cleared on both sides (reference clear_isotope)."""
    prod = [(mol, a.idx) for mol in products for a in mol.atoms if a.atom_map]
    reac = [(mol, a.idx) for mol in reactants for a in mol.atoms if a.atom_map]
    prod_tags = [str(mol.atoms[i].atom_map) for mol, i in prod]
    reac_tags = [str(mol.atoms[i].atom_map) for mol, i in reac]
    atoms, tags = [], []
    for i, ptag in enumerate(prod_tags):
        for j, rtag in enumerate(reac_tags):
            if rtag != ptag or rtag in tags:
                continue
            pmol, pidx = prod[i]
            rmol, ridx = reac[j]
            if _atom_changed(pmol, pidx, rmol, ridx, remote):
                atoms.append(rmol.atoms[ridx])
                tags.append(rtag)
                break
            if prod_tags.count(rtag) > 1:  # stoichiometry > 1
                atoms.append(rmol.atoms[ridx])
                tags.append(rtag)
                break
    for j, rtag in enumerate(reac_tags):
        if rtag not in tags and rtag not in prod_tags:
            rmol, ridx = reac[j]
            atoms.append(rmol.atoms[ridx])
            tags.append(rtag)
    for mol in list(reactants) + list(products):
        for a in mol.atoms:
            a.isotope = 0
    return atoms, tags


# ---------------------------------------------------------------------------
# fragment SMARTS (reference get_fragments_for_changed_atoms)
# ---------------------------------------------------------------------------

def strict_atom_token(atom, use_symbol: bool = True) -> str:
    """Strictest per-atom SMARTS label (reference
    get_strict_smarts_for_atom, template_extractor.py:355-375): element +
    map only, lowercase when aromatic; H / charge / chirality are carried by
    the template's side-channel change codes instead."""
    if atom.symbol == "H":
        return "[#1]"
    if not use_symbol:
        return f"[A:{atom.atom_map}]"
    sym = atom.symbol.lower() if atom.aromatic else atom.symbol
    return f"[{sym}:{atom.atom_map}]"


def full_atom_token(atom, chirality_out: int) -> str:
    """Fully-specified token for unmapped (leaving-group) atoms: element,
    isotope, chirality, explicit H count, charge (role of GetSmarts under
    allHsExplicit)."""
    parts = ["["]
    if atom.isotope:
        parts.append(str(atom.isotope))
    if atom.symbol == "H":
        parts.append("#1")  # the own SMARTS parser reads bare 'H' as H-count
    else:
        parts.append(atom.symbol.lower() if atom.aromatic else atom.symbol)
    if chirality_out == CHI_CCW:
        parts.append("@")
    elif chirality_out == CHI_CW:
        parts.append("@@")
    if atom.symbol != "H":
        h = atom.total_h
        if h == 1:
            parts.append("H")
        elif h > 1:
            parts.append(f"H{h}")
    if atom.charge == 1:
        parts.append("+")
    elif atom.charge == -1:
        parts.append("-")
    elif atom.charge:
        parts.append(f"{atom.charge:+d}")
    parts.append("]")
    return "".join(parts)


def _subset_components(mol: Mol, atom_subset: Sequence[int]) -> List[List[int]]:
    """Connected components of the induced subgraph (a fragment selection
    can be disconnected within one molecule; RDKit writes it '.'-joined)."""
    in_set = set(atom_subset)
    seen, comps = set(), []
    for a in atom_subset:
        if a in seen:
            continue
        stack, comp = [a], []
        seen.add(a)
        while stack:
            x = stack.pop()
            comp.append(x)
            for nb in mol.neighbors(x):
                if nb in in_set and nb not in seen:
                    seen.add(nb)
                    stack.append(nb)
        comps.append(sorted(comp))
    return comps


def write_fragment_smarts(mol: Mol, atoms_to_use: Sequence[int],
                          token_fn) -> str:
    """Strict-SMARTS serialization of an atom selection: custom tokens,
    every bond explicit (role of AllChem.MolFragmentToSmiles with
    atomSymbols / allHsExplicit / allBondsExplicit, reference
    template_extractor.py:408-411)."""
    parts = []
    for comp in _subset_components(mol, atoms_to_use):
        ranks = canonical_ranks(mol, atom_subset=comp)
        parts.append(write_smiles(mol, rank_of=ranks, atom_subset=comp,
                                  atom_token_fn=token_fn,
                                  all_bonds_explicit=True))
    return ".".join(parts)


def fragments_for_changed_atoms(mols: Sequence[Mol], tags: List[str],
                                category: str, settings: Dict
                                ) -> Tuple[str, bool, bool]:
    """Strict SMARTS fragments around changed atoms; reactant-side fragments
    absorb their unmapped atoms (leaving groups)
    (reference get_fragments_for_changed_atoms,
    template_extractor.py:377-424)."""
    retro = settings["retro"]
    use_stereo = settings["use_stereo"]
    fragments = ""
    mols_changed = []
    for mol in mols:
        mapped = [a.idx for a in mol.atoms
                  if a.atom_map and str(a.atom_map) in tags]
        mapped_set = set(mapped)
        atoms_to_use = list(mapped)
        if category == "reactant" and atoms_to_use and retro:
            atoms_to_use += [a.idx for a in mol.atoms if not a.atom_map]
        if not atoms_to_use:
            continue

        def token_fn(idx, chi, mol=mol, mapped_set=mapped_set):
            atom = mol.atoms[idx]
            if idx in mapped_set:
                return strict_atom_token(atom, settings["use_symbol"])
            return full_atom_token(atom, chi if use_stereo else CHI_NONE)

        fragments += f"({write_fragment_smarts(mol, atoms_to_use, token_fn)})."
        mols_changed.append(demapped_canonical(mol))
    intra_only = len(mols_changed) == 1
    dimer_only = len(set(mols_changed)) == 1 and len(mols_changed) == 2
    return fragments[:-1], intra_only, dimer_only


# ---------------------------------------------------------------------------
# main entry (reference extract_from_reaction)
# ---------------------------------------------------------------------------

def _clear_stereo(mol: Mol) -> None:
    for a in mol.atoms:
        a.chirality = CHI_NONE
    for b in mol.bonds:
        b.direction = 0


def _validate_template(template: str) -> bool:
    """Both sides must parse as SMARTS with at least one atom (role of
    AllChem.ReactionFromSmarts(...).Validate())."""
    try:
        for side in template.split(">>"):
            if not parse_smarts(side).atoms:
                return False
    except (SmartsParseError, ValueError):
        return False
    return True


def extract_template_native(rxn_smiles_or_dict, settings: Optional[Dict] = None
                            ) -> Dict:
    """Extract a canonical retro template + edit labels from one mapped
    reaction with the own chem kit (native twin of
    extractor.extract_template; reference extract_from_reaction,
    template_extractor.py:517-626). Returns the same dict schema, or just
    {'reaction_id'} when the reaction cannot be processed."""
    settings = {**DEFAULT_SETTINGS, **(settings or {})}
    if isinstance(rxn_smiles_or_dict, str):
        parts = rxn_smiles_or_dict.split(">>")
        reaction = {"reactants": parts[0], "products": parts[1], "_id": 0}
    else:
        reaction = rxn_smiles_or_dict
    failure = {"reaction_id": reaction["_id"]}

    try:
        reactant_list, product_list, reagent_list = split_reagents(
            reaction["reactants"], reaction["products"],
            settings["least_atom_num"])
        product_maps = {a.atom_map for s in product_list
                        for a in parse_smiles(s).atoms}
        products = demap_except(product_list, product_maps)
        reactants = []
        for mol in demap_except(reactant_list, product_maps):
            # fully unmapped reactants are spectators in retro mode
            if all(a.atom_map == 0 for a in mol.atoms):
                reagent_list.append(demapped_canonical(mol))
            else:
                reactants.append(mol)
        reactants = [remove_explicit_hydrogens(m) for m in reactants]
        products = [remove_explicit_hydrogens(m) for m in products]
        if not settings["use_stereo"]:
            for m in reactants + products:
                _clear_stereo(m)
    except Exception:
        return failure

    atoms, tags = changed_atoms(reactants, products, settings["remote"])
    if not tags:
        return failure

    try:
        reactant_frags, intra_only, dimer_only = fragments_for_changed_atoms(
            reactants, tags, "reactant", settings)
        product_frags, _, _ = fragments_for_changed_atoms(
            products, tags, "product", settings)
    except (ValueError, RecursionError):
        return failure

    transform = reactant_frags + ">>" + product_frags
    atom_props = {str(a.atom_map): {"charge": a.charge,
                                    "Hs": max(a.explicit_h, 0)}
                  for a in atoms}
    transform = ">>".join(reorder_sides(x) for x in transform.split(">>"))
    canonical, replacement_dict = reassign_atom_maps(
        transform, atom_props, retro=settings["retro"],
        canonicalize_smarts=None)

    reactants_string, products_string = canonical.split(">>")
    products_smiles = ".".join(mol_to_mapped_smiles(p) for p in products)
    reactants_smiles = ".".join(mol_to_mapped_smiles(r) for r in reactants)

    if settings["retro"]:
        canonical_template = products_string + ">>" + reactants_string
    else:
        canonical_template = reactants_string + ">>" + products_string

    edits, h_change, charge_change, chiral_change = native_labeling.match_label(
        reactants_smiles, products_smiles, replacement_dict, tags,
        retro=settings["retro"], remote=settings["remote"],
        use_stereo=settings["use_stereo"])

    if not _validate_template(canonical_template):
        return failure

    return {
        "products": products_smiles,
        "reactants": reactants_smiles,
        "necessary_reagent": [demapped_canonical(m)
                              for m in demap_except(reagent_list, set())],
        "reaction_smarts": canonical_template,
        "intra_only": intra_only,
        "dimer_only": dimer_only,
        "reaction_id": reaction["_id"],
        "replacement_dict": replacement_dict,
        "change_atoms": tags,
        "edits": edits,
        "H_change": h_change,
        "Charge_change": charge_change,
        "Chiral_change": chiral_change,
    }
