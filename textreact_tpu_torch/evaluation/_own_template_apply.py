"""Own-chem-kit local-template application (template-based retro decoding;
own copy of textreact_tpu/evaluation/_own_template_apply.py).

The port's only template engine, with the decode semantics of the
reference (template_decoder.py:20-37, 158-196): run the
predicted retro template at the predicted edit site with the native
reaction engine (chem/reaction.py), keep reactant sets whose matched atoms
line up with the prediction, patch H/charge/chirality from the template
info, demap, canonicalize. It needs no RDKit, so the same engine decodes
in the tests and on the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..chem import parse_smiles
from ..chem.canon import canonical_ranks, write_smiles
from ..chem.mol import CHI_CCW, CHI_CW, CHI_NONE, Mol, clear_impossible_stereo
from ..chem.reaction import (mol_fragments_smiles, run_retro_template,
                             valence_ok)

# -1 = stereocenter destroyed -> clear the tag (reference chiral_type_map:
# CHI_UNSPECIFIED maps to -1, template_decoder.py:15)
_INT_TO_CHIRAL = {1: CHI_CW, 2: CHI_CCW, -1: CHI_NONE}


def apply_ranked_edits(template_preds: Sequence[Tuple], product: str,
                       atom_templates: Dict[int, str],
                       bond_templates: Dict[int, str],
                       template_infos: Dict[str, Dict],
                       top_k: int) -> List[str]:
    """Walk the ranked edit list, decoding each until top_k distinct valid
    reactant SMILES are collected."""
    results: List[str] = []
    for pred in template_preds:
        decoded = _try_decode(pred, product, atom_templates, bond_templates,
                              template_infos)
        if decoded is None or decoded in results:
            continue
        results.append(decoded)
        if len(results) >= top_k:
            break
    return results


def _canonical_frag_index(mol: Mol) -> Dict[int, int]:
    """Atom idx in the whole product -> atom idx within its own canonical
    fragment (reference template_decoder.py:59-69; needed when a template's
    product side has multiple fragments)."""
    ranks = canonical_ranks(mol)
    mapping: Dict[int, int] = {}
    for frag in mol.fragment_atom_sets():
        _smiles, order = write_smiles(mol, rank_of=ranks, atom_subset=frag,
                                      with_atom_order=True)
        for pos, orig in enumerate(order):
            mapping[orig] = pos
    return mapping


def _try_decode(pred, product: str, atom_templates, bond_templates,
                template_infos) -> Optional[str]:
    try:
        if len(pred) < 4:
            return None
        edit_type, site, template_class, _score = pred
        mol = parse_smiles(product)
        table = atom_templates if edit_type == "a" else bond_templates
        template = table[template_class]
        info = template_infos[template]
        multi_frag = len(template.split(">>")[0].split(".")) > 1
        if multi_frag:
            frag_idx = _canonical_frag_index(mol)
            site = (frag_idx[site] if edit_type == "a"
                    else (frag_idx[site[0]], frag_idx[site[1]]))
        local = ">>".join(f"({part})" for part in
                          template.split("_")[0].split(">>"))
        return _run_template(mol, site, local, info)
    except Exception:
        return None


def _site_maps(site, info) -> List[Dict[int, int]]:
    """Candidate {template atom-map -> product atom idx} bindings for the
    predicted edit site (reference get_possible_map)."""
    out: List[Dict[int, int]] = []
    if isinstance(site, int):
        for kind, edits in info["edit_site"].items():
            if kind in ("A", "R"):
                out.extend({e: site} for e in edits)
    else:
        for kind, edits in info["edit_site"].items():
            if kind in ("B", "C"):
                out.extend({e: s for e, s in zip(edit, site)}
                           for edit in edits)
    return out


def _run_template(product: Mol, site, template: str, info) -> Optional[str]:
    candidates = _site_maps(site, info)
    if not candidates:
        return None
    for applied in run_retro_template(product, template, check_valence=False):
        found = applied.map_to_product
        if not any(cand.items() <= found.items() for cand in candidates):
            continue
        fixed = _patch_atoms(product, applied, info)
        if fixed is not None:
            return fixed
    return None


def _patch_atoms(product: Mol, applied, info) -> Optional[str]:
    """Apply the template's H/charge/chirality deltas to matched atoms
    (reference fix_reactant_atoms), then demap and canonicalize; None if
    any patch is inconsistent."""
    for mapno, new_idx in applied.map_to_new.items():
        if mapno not in applied.map_to_product:
            return None
        src = product.atoms[applied.map_to_product[mapno]]
        h = src.total_h + info["change_H"][mapno]
        if h < 0:
            return None
        atom = applied.mol.atoms[new_idx]
        atom.explicit_h = h
        atom.implicit_h = h
        atom.charge = src.charge + info["change_C"][mapno]
        s_after = info["change_S"][mapno]
        if s_after != 0:
            atom.chirality = _INT_TO_CHIRAL.get(s_after, atom.chirality)
    if not valence_ok(applied.mol):
        return None
    # role of reference validate_mols' MolFromSmiles(MolToSmiles()) pass:
    # template application can leave a tetrahedral tag on a now-planar atom
    clear_impossible_stereo(applied.mol)
    return mol_fragments_smiles(applied.mol)
