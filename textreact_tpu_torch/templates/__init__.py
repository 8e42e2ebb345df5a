"""Template preprocessing (offline): extraction + labeling (own copy of
textreact_tpu/templates/ on the own chem kit).

Pure-string SMARTS canonicalization (smarts_canon) is engine-free. The
graph passes run on the native engine (native_extractor.py /
native_labeling.py), the same pipeline on the own chem kit, whose
templates round-trip through the own reaction engine that the port's
template decode applies. The JAX package's RDKit engine is not copied: no
environment of the port has RDKit, and engine='rdkit' raises
NotImplementedError there as here.
"""

from .smarts_canon import (count_atoms, enumerate_label_orders,
                           fragment_permutations, invert_chain,
                           invert_template, reassign_atom_maps, reorder_sides,
                           sort_fragments, template_score)

__all__ = [
    "count_atoms", "enumerate_label_orders", "fragment_permutations",
    "invert_chain", "invert_template", "reassign_atom_maps", "reorder_sides",
    "sort_fragments", "template_score", "extract_template",
    "TemplateProcessor",
]


def __getattr__(name):
    # lazy, as in the JAX package, where the graph layers check for RDKit
    # at call time
    if name == "extract_template":
        from .extractor import extract_template
        return extract_template
    if name == "TemplateProcessor":
        from .processor import TemplateProcessor
        return TemplateProcessor
    raise AttributeError(name)
