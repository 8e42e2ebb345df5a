"""Edit-site labeling for extracted templates: the engine-free helpers and
the dispatch (own copy of textreact_tpu/templates/labeling.py without its
RDKit half; the port labels on the own chem kit, native_labeling.py).

Reimplements reference preprocess/template_extraction/
template_extract_utils.py: classify each changed atom/bond as a
leaving-group attachment (A), broken bond (B), changed bond (C) or remote
participant (R), map atom-map numbers to atom indices and renumbered
template positions, and record per-atom H/charge/chirality deltas.
"""

from __future__ import annotations

from typing import Dict, Sequence, Set, Tuple

_RDKIT_ENGINE_MISSING = (
    "engine='rdkit' requires RDKit; use engine='native' (own chem kit) in "
    "RDKit-less environments")


def _native_engine(engine: str) -> None:
    """'auto' and 'native' take the own chem kit; the port has no RDKit
    engine, so any other raises, as the JAX package's does without RDKit."""
    if engine not in ("auto", "native"):
        raise NotImplementedError(_RDKIT_ENGINE_MISSING)


def _bonds_to_positions(bond_maps, idx_of: Dict[int, int],
                        pos_of: Dict[int, int], sort: bool = False,
                        remote: bool = False):
    """(atom-idx pairs, map pairs, template-position pairs) per bond
    (reference bondmap2idx, template_extract_utils.py:272-294)."""
    idxs = [(idx_of[a], idx_of[b]) for a, b in bond_maps]
    if remote:
        temps = list({(pos_of[a], -1) for a, _ in bond_maps})
        return idxs, list(bond_maps), temps
    temps = [(pos_of[a], pos_of[b]) for a, b in bond_maps]
    if not sort:
        return idxs, list(bond_maps), temps
    s_idx, s_map, s_tmp = [], [], []
    for i, m, t in zip(idxs, bond_maps, temps):
        if t[0] < t[1]:
            s_idx.append(i)
            s_map.append(m)
            s_tmp.append(t)
        else:
            s_idx.append(tuple(i[::-1]))
            s_map.append(tuple(m[::-1]))
            s_tmp.append(tuple(t[::-1]))
    return s_idx, s_map, s_tmp


def _atoms_to_positions(atom_maps, idx_of, pos_of):
    return ([idx_of[m] for m in atom_maps], list(atom_maps),
            [pos_of[m] for m in atom_maps])


def match_label(reactants: str, products: str, replacement_dict: Dict,
                edit_maps: Sequence[str], retro: bool = True,
                remote: bool = True, use_stereo: bool = True,
                engine: str = "rdkit"):
    """Full labeling of one extracted reaction (reference match_label,
    template_extract_utils.py:301-326): engine 'native' (or 'auto') is the
    own-chem-kit labeling of native_labeling."""
    _native_engine(engine)
    from . import native_labeling
    return native_labeling.match_label(
        reactants, products, replacement_dict, edit_maps,
        retro=retro, remote=remote, use_stereo=use_stereo)


def bonds_from_smiles(smiles: str, engine: str = "auto"
                      ) -> Set[Tuple[int, int]]:
    """All directed bonded atom-index pairs of a molecule (reference
    get_bonds_from_smiles, template_extract_utils.py:328-340)."""
    _native_engine(engine)
    from . import native_labeling
    return native_labeling.bonds_from_smiles(smiles)
