"""Pure-string SMARTS template canonicalization (own copy of
textreact_tpu/templates/smarts_canon.py).

Reimplements the rdchiral-lineage template normalization the reference uses
(reference preprocess/template_extraction/template_extractor.py:198-353):
fragment sorting, linear-template inversion, atom-map reassignment with
symmetry enumeration. The extractor emits strict SMARTS where every atom is
bracketed (allHsExplicit + allBondsExplicit), so atom counting and label
manipulation are plain string operations here, independent of RDKit.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

_LABELED = re.compile(r"\[[a-zA-Z@]+\:.*?\]")
_LABELED_NUM = re.compile(r"\[[a-zA-Z@]+\:(.*?)\]")
_ANY_BRACKET = re.compile(r"\[.*?]")
_BOND_AFTER_BRACKET = re.compile(r"]([-=#:])|]1([-=#:])")
_BOND_BETWEEN = re.compile(r"\]([-=#:])\[")
_CHARGE = re.compile(r"\;(.+?[0-9]+)\:")
_MAP_SUFFIX = re.compile(r"\:[0-9]+\]")

BOND_SCORE = {"-": 1, ":": 2, "=": 3, "#": 4}


def count_atoms(smarts: str) -> int:
    """Atom count of a strict (all-bracket) SMARTS fragment."""
    return len(_ANY_BRACKET.findall(smarts))


def template_score(template: str, atom_props: Dict[str, Dict[str, int]]) -> float:
    """Fragment ordering score: weighted bond symbols + charge/H of mapped
    atoms (reference template_extractor.py:198-204)."""
    score = 0.0
    for sym, s in BOND_SCORE.items():
        score += template.count(sym) * s
    for n in re.findall(r"\:([0-9]+)\]", template):
        props = atom_props.get(n, {"charge": 0, "Hs": 0})
        score += 0.1 * props["charge"] + 0.01 * props["Hs"]
    return score


def invert_chain(template: str) -> str:
    """Reverse a small linear labeled chain when map numbers run backwards
    (reference inv_temp, template_extractor.py:206-217)."""
    symbols = _LABELED.findall(template)
    nums = [int(n) for n in _LABELED_NUM.findall(template)]
    if len(nums) not in (2, 3) or "]1" in template:
        return template
    if nums[0] < nums[1]:
        return template
    if len(nums) == 3 and nums[0] < nums[2]:
        return template
    bonds = [""] + [sorted(b)[1] for b in _BOND_AFTER_BRACKET.findall(template)]
    if len(bonds) != len(symbols):
        # bond symbols outside -=#: (e.g. stereo '/' '\\') are invisible to
        # the regex; reversing would drop them — leave the chain as-is
        return template
    return "".join(f"{a}{b}" for a, b in zip(symbols[::-1], bonds[::-1]))


def invert_template(template: str) -> str:
    """Reverse a whole linear fragment when the reversed bond string scores
    lower (reference inverse_template, template_extractor.py:219-251)."""
    labels = _LABELED.findall(template)
    if count_atoms(template) > len(labels):  # carries a leaving group
        return template

    def bond_rank(bonds: List[str]) -> int:
        return int("".join(str(BOND_SCORE[b]) for b in bonds))

    ring = "]1" in template
    bonds = [sorted(b)[1] for b in _BOND_AFTER_BRACKET.findall(template)]
    rev = bonds[::-1]
    if not bonds or ")" in template or bond_rank(bonds) <= bond_rank(rev):
        return template
    if len(bonds) != (len(labels) if ring else len(labels) - 1):
        return template  # stereo '/' '\\' bonds: reversal would drop them
    all_labels = _ANY_BRACKET.findall(template)[::-1]
    out = all_labels[0]
    for i in range(len(rev)):
        if ring:
            if i == 0:
                out += "1"
            if i + 1 == len(all_labels):
                out += rev[0] + "1"
            else:
                out += rev[i + 1] + all_labels[i + 1]
        else:
            out += rev[i] + all_labels[i + 1]
    return out


def sort_fragments(transform: str, atom_props: Dict[str, Dict[str, int]],
                   canonicalize_smarts=None) -> str:
    """Order each side's fragments by score and normalize each fragment
    (reference sort_template, template_extractor.py:268-280). The optional
    `canonicalize_smarts` hook is the RDKit round-trip normalizer."""
    lhs, rhs = transform.split(">>")
    lhs = lhs[1:-1].replace(").(", ".")
    rhs = rhs[1:-1].replace(").(", ".")
    sides = []
    for side in (lhs, rhs):
        frags = []
        for smarts in sorted(side.split("."),
                             key=lambda s: template_score(s, atom_props)):
            if canonicalize_smarts is not None:
                smarts = canonicalize_smarts(smarts)
            try:
                frags.append(invert_template(smarts))
            except Exception:
                frags.append(smarts)
        sides.append(".".join(frags))
    return ">>".join(sides)


def fragment_permutations(template: str) -> List[List[str]]:
    """Symmetric linear fragments admit a reversed label order
    (reference permutations, template_extractor.py:282-291)."""
    labels = _LABELED.findall(template)
    if len(labels) == 1 or "(" in template or count_atoms(template) > len(labels):
        return [labels]
    charges = _CHARGE.findall(template)
    bonds = _BOND_BETWEEN.findall(template)
    if "".join(bonds) != "".join(bonds[::-1]) or \
       "".join(charges) != "".join(charges[::-1]):
        return [labels]
    return [labels, labels[::-1]]


def enumerate_label_orders(transform: str) -> List[List[str]]:
    """Cartesian product of per-fragment label orders over both sides
    (reference enumerate_mapping, template_extractor.py:293-315)."""
    per_side = []
    for side in transform.split(">>"):
        grown: List[List[str]] = [[]]
        for frag in side.split("."):
            options = fragment_permutations(frag)
            grown = [g + o for g in grown for o in options]
        per_side.append(grown)
    return [r + p for r in per_side[0] for p in per_side[1]]


def reorder_sides(template: str) -> str:
    """Sort molecules/fragments within one side by their label-stripped
    strings (reference canonicalize_template, template_extractor.py:435-465)."""
    nolabel = _MAP_SUFFIX.sub("]", template)
    nolabel_mols = nolabel[1:-1].split(").(")
    mols = template[1:-1].split(").(")
    for i in range(len(mols)):
        nl_frags = nolabel_mols[i].split(".")
        frags = mols[i].split(".")
        order = [j for j, _ in sorted(enumerate(nl_frags), key=lambda x: x[1])]
        nolabel_mols[i] = ".".join(nl_frags[j] for j in order)
        mols[i] = ".".join(frags[j] for j in order)
    order = [j for j, _ in sorted(enumerate(nolabel_mols), key=lambda x: x[1])]
    return "(" + ").(".join(mols[i] for i in order) + ")"


def reassign_atom_maps(transform: str, atom_props: Dict[str, Dict[str, int]],
                       retro: bool = True, canonicalize_smarts=None
                       ) -> Tuple[str, Dict[str, str]]:
    """Renumber atom maps 1..n in canonical label order, choosing the
    lexicographically smallest relabeling over symmetry permutations
    (reference reassign_atom_mapping, template_extractor.py:317-353).
    Returns (template, {old_map: new_map})."""
    if not retro:
        transform = ">>".join(transform.split(">>")[::-1])
    transform = sort_fragments(transform, atom_props, canonicalize_smarts)
    candidates = {}
    replacement_dicts = {}
    for labels in enumerate_label_orders(transform):
        replacements: List[str] = []
        seen_symbol: Dict[str, str] = {}
        mapping: Dict[str, str] = {}
        counter = 1
        for label in labels:  # order matters
            atom_map = label.split(":")[1].split("]")[0]
            if atom_map not in mapping:
                seen_symbol[label] = f"{label.split(':')[0]}:{counter}]"
                mapping[atom_map] = str(counter)
                counter += 1
            else:
                seen_symbol[label] = f"{label.split(':')[0]}:{mapping[atom_map]}]"
            replacements.append(seen_symbol[label])
        queue = list(replacements)
        relabeled = _LABELED.sub(lambda m: queue.pop(0), transform)
        if retro:
            lhs, rhs = relabeled.split(">>")
            relabeled = lhs + ">>" + ".".join(invert_chain(s)
                                              for s in rhs.split("."))
        else:
            relabeled = ">>".join(relabeled.split(">>")[::-1])
        candidates[relabeled] = "".join(_LABELED.findall(relabeled))
        replacement_dicts[relabeled] = mapping
    best = min(candidates, key=lambda t: candidates[t])
    return best, replacement_dicts[best]
