"""USPTO condition extraction pipeline, raw CML XML -> condition CSVs (own
copy of textreact_tpu/preprocess/condition_extraction.py over
utils/table.py).

Roles of reference preprocess/uspto_script stages 1-3:
1. 1.get_condition_from_uspto.py — parse the CML reaction XML, collect per-
   reaction solvent/catalyst/reagent SMILES (spectator roles), reaction
   SMILES, and paragraph text for the corpus. Implemented here with the
   stdlib XML parser (no xmltodict).
2. 2.0.clean_up_rxn_condition.py — re-map atoms with RXNMapper and
   reassign unmapped precursor fragments to reagents. RXNMapper is an
   external neural service; gated.
3. 2.1/3.0 — merge + dedup, per-role frequency tables, frequency threshold
   filtering, excess-condition removal (>1 catalyst / >2 solvents /
   >2 reagents, per Gao et al. 2018), and slot splitting with the reference
   SPLIT_TOKEN.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

from ..utils.table import Table, concat, fillna, isna

# the reference separates multi-component slots with this token
# (3.0.split_condition_and_slect.py:16)
SPLIT_TOKEN = "分"


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def parse_cml_reactions(xml_path: str, year: Optional[int] = None,
                        patent_type: str = "grant"
                        ) -> Tuple[List[Dict], List[Dict], Dict[str, Dict]]:
    """Parse one CML reaction file. Returns (condition rows, corpus rows,
    patent_info) with the reference's column schema
    (1.get_condition_from_uspto.py:14-31)."""
    tree = ET.parse(xml_path)
    root = tree.getroot()
    if year is None:
        try:
            year = int(os.path.basename(os.path.dirname(xml_path)))
        except ValueError:
            year = -1
    condition_rows: List[Dict] = []
    corpus_rows: List[Dict] = []
    patent_info: Dict[str, Dict] = {}
    patent_cnt: Counter = Counter()

    for reaction in root.iter():
        if _local(reaction.tag) != "reaction":
            continue
        source = {}
        spectators: Dict[str, List[str]] = defaultdict(list)
        rxn_smiles = None
        for el in reaction.iter():
            name = _local(el.tag)
            if name in ("documentId", "headingText", "paragraphText"):
                source[name] = el.text or ""
            elif name == "reactionSmiles":
                rxn_smiles = el.text
            elif name == "spectator":
                role = el.get("role", "")
                for ident in el.iter():
                    if _local(ident.tag) == "identifier" and \
                            ident.get("dictRef") == "cml:smiles":
                        spectators[role].append(ident.get("value", ""))
        patent_id = source.get("documentId")
        if not patent_id or rxn_smiles is None:
            continue
        patent_info[patent_id] = {"year": year, "type": patent_type}
        rxn_id = f"{patent_id}_{patent_cnt[patent_id]}"
        patent_cnt[patent_id] += 1
        condition_rows.append({
            "id": rxn_id, "source": patent_id, "year": year,
            "patent_type": patent_type, "rxn_smiles": rxn_smiles,
            "solvent": ".".join(sorted(set(spectators["solvent"]))),
            "catalyst": ".".join(sorted(set(spectators["catalyst"]))),
            "reagent": ".".join(sorted(set(spectators["reagent"]))),
        })
        corpus_rows.append({
            "id": rxn_id, "year": year, "patent_type": patent_type,
            "xml": os.path.basename(xml_path),
            "heading_text": source.get("headingText", ""),
            "paragraph_text": source.get("paragraphText", ""),
        })
    return condition_rows, corpus_rows, patent_info


def remap_reaction(rxn_smiles: str, solvent: str, catalyst: str, reagent: str
                   ) -> Optional[Dict]:
    """RXNMapper atom re-mapping + reagent reassignment (reference
    2.0.clean_up_rxn_condition.py:17-77). Unmapped precursor fragments that
    aren't already known conditions become reagents. Gated on rxnmapper."""
    try:
        from rxnmapper import RXNMapper  # external neural mapper
    except ImportError as e:
        raise NotImplementedError(
            "reaction re-mapping uses the external RXNMapper model "
            "(as in the reference); install rxnmapper") from e
    mapper = RXNMapper()
    rxn = rxn_smiles.split(" ")[0]
    result = mapper.get_attention_guided_atom_maps([rxn])[0]
    remapped = result["mapped_rxn"]
    precursors, products = remapped.split(">>")
    map_re = re.compile(r":(\d+)]")
    reactants, unmapped = [], []
    for frag in precursors.split("."):
        (reactants if map_re.search(frag) else unmapped).append(frag)
    if sorted(map_re.findall(".".join(reactants))) != \
            sorted(map_re.findall(products)):
        return None
    known = set(catalyst.split(".")) | set(solvent.split(".")) | set(reagent.split("."))
    extra_reagents = [f for f in unmapped if f not in known]
    return {
        "remapped_rxn": ".".join(reactants) + ">>" + products,
        "confidence": result["confidence"],
        "reagent": ".".join([r for r in [reagent] + extra_reagents if r]),
    }


def merge_and_dedup(chunks: List[Table]) -> Tuple[Table, Dict[str, Table]]:
    """Concatenate chunk CSVs, drop duplicate reaction+condition rows, and
    build per-role frequency tables (reference 2.1.merge...py:40-60)."""
    db = concat(chunks)
    keys = [c for c in ("remapped_rxn", "canonical_rxn", "catalyst",
                        "solvent", "reagent") if c in db.columns]
    db = db.drop_duplicates(keys)
    freqs = {}
    for role in ("catalyst", "solvent", "reagent"):
        counts = Counter(fillna(db[role], ""))
        ranked = sorted(counts.items(), key=lambda kv: -kv[1])
        freqs[role] = Table({"smiles": [s for s, _ in ranked],
                             "freq_cnt": [n for _, n in ranked]})
    return db, freqs


def filter_and_split_conditions(db: Table,
                                freqs: Dict[str, Table],
                                remove_threshold: int = 100,
                                ionic_table=None) -> Table:
    """Frequency filtering + ionic reagent splitting + excess removal + slot
    splitting (reference 3.0.split_condition_and_slect.py:29-181):

    1. drop rows whose catalyst/solvent/reagent combo has corpus frequency
       below `remove_threshold` (3.0:29-39); empty/NaN combos never drop;
    2. strip each unique reagent combo of known ionic compounds and classify
       leftovers by formal charge (ionic.split_reagent_combination; reference
       MolRemover + get_mol_charge, 3.0:93-122). Charged leftovers vanish
       from the reagent list; rows with NOTHING known left are dropped
       (3.0:123-127);
    3. excess removal per Gao et al. 2018 (3.0:135-152): catalyst with >1
       '.'-fragment, solvent with >2, or reagent with >2 known components;
    4. *_split columns: catalyst verbatim, solvent '.'-split, reagent =
       known components, all joined with SPLIT_TOKEN (3.0:153-172)."""
    from .ionic import IonicCompoundTable, split_reagent_combination
    if ionic_table is None:
        ionic_table = IonicCompoundTable.load()

    keep = [True] * len(db)
    for role in ("catalyst", "solvent", "reagent"):
        table = freqs[role]
        rare = {s for s, n in zip(table["smiles"], table["freq_cnt"])
                if n < remove_threshold}
        rare.discard("")
        keep = [k and v not in rare
                for k, v in zip(keep, fillna(db[role], ""))]
    db = db.take(keep)

    # per-unique-combo ionic split (the reference builds reagent2index_dict
    # to do this once per distinct combo, 3.0:41-44)
    reagent_known: Dict[str, List[str]] = {}
    for combo in dict.fromkeys(fillna(db["reagent"], "")):
        known, _unknown = split_reagent_combination(combo if combo else None,
                                                    ionic_table)
        reagent_known[combo] = known
    keep = [bool(reagent_known[r]) for r in fillna(db["reagent"], "")]
    db = db.take(keep)

    def parts(value: str) -> List[str]:
        return [p for p in str(value).split(".") if p] if not isna(value) else []

    # excess removal: catalyst > 1, solvent > 2, reagent > 2 known components
    keep = [len(parts(c)) <= 1 and len(parts(s)) <= 2
            and len([k for k in reagent_known[r] if k]) <= 2
            for c, s, r in zip(fillna(db["catalyst"], ""),
                               fillna(db["solvent"], ""),
                               fillna(db["reagent"], ""))]
    db = db.take(keep)

    db["catalyst_split"] = fillna(db["catalyst"], "")
    db["solvent_split"] = [SPLIT_TOKEN.join(parts(s))
                           for s in fillna(db["solvent"], "")]
    db["reagent_split"] = [SPLIT_TOKEN.join(reagent_known[r])
                           for r in fillna(db["reagent"], "")]
    return db


def split_condition_slots(db: Table) -> Table:
    """Expand *_split columns into the 5 condition slots
    (reference 4.0.split_train_val_test.py:27-34)."""
    out = db.copy()
    out["catalyst1"] = out["catalyst_split"]

    def two(value):
        bits = str(value).split(SPLIT_TOKEN, 1)
        return bits[0], bits[1] if len(bits) > 1 else ""

    sol = [two(v) for v in out["solvent_split"]]
    rea = [two(v) for v in out["reagent_split"]]
    out["solvent1"] = [a for a, _ in sol]
    out["solvent2"] = [b for _, b in sol]
    out["reagent1"] = [a for a, _ in rea]
    out["reagent2"] = [b for _, b in rea]
    return out
