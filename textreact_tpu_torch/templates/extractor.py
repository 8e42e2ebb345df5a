"""Retro template extraction from atom-mapped reactions: the settings and
the engine dispatch (own copy of textreact_tpu/templates/extractor.py
without its RDKit engine; the port extracts on the own chem kit,
native_extractor.py).

Reimplements the rdchiral-lineage extractor the reference vendors
(reference preprocess/template_extraction/template_extractor.py:517-626,
itself derived from the public rdchiral project). Settings mirror the
reference dict (use_stereo/use_symbol=True for the TextReact pipeline,
get_templates.py:130-132).
"""

from __future__ import annotations

from typing import Dict, Optional

from .labeling import _native_engine

DEFAULT_SETTINGS = {
    "verbose": False, "use_stereo": True, "use_symbol": True,
    "max_unmap": 5, "retro": True, "remote": True, "least_atom_num": 2,
}


def extract_template(rxn_smiles_or_dict, settings: Optional[Dict] = None,
                     engine: str = "auto") -> Dict:
    """Extract a canonical retro template + edit labels from one mapped
    reaction (reference extract_from_reaction, template_extractor.py:517-626).

    Returns a dict with reaction_smarts / edits / H_change / Charge_change /
    Chiral_change / replacement_dict etc., or just {'reaction_id'} when the
    reaction cannot be processed. `engine` 'auto' and 'native' run the own
    chem kit; 'rdkit' raises NotImplementedError.
    """
    _native_engine(engine)
    from .native_extractor import extract_template_native
    return extract_template_native(rxn_smiles_or_dict, settings)
