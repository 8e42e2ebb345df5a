"""Template preprocessing: extract + label (offline; own copy of
textreact_tpu/templates/processor.py on the own chem kit, writing its
tables through utils/table.py).

Role of reference preprocess/get_templates.py (LocalRetroProcessor): pass 1
extracts templates from the mapped training reactions into
template_infos.csv / atom_templates.csv / bond_templates.csv; pass 2
re-extracts every split and writes preprocessed_{split}.csv with per-
reaction edit Labels, the product's original-atom -> canonical-atom index
permutation, and the canonical product's bond list — exactly the artifacts
data/templates.py consumes at train time.

Engine: the port has the native engine only, the one its template decode
(evaluation/template_decode.py) applies, so 'auto' resolves to 'native';
'rdkit' raises NotImplementedError, as the JAX package's processor does
wherever RDKit is absent. Nothing runs on a device.
"""

from __future__ import annotations

import csv
import logging
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.table import Table, concat
from .extractor import DEFAULT_SETTINGS, extract_template
from .labeling import _native_engine, bonds_from_smiles

log = logging.getLogger(__name__)

PIPELINE_SETTINGS = {**DEFAULT_SETTINGS, "use_stereo": True, "use_symbol": True,
                     "max_edit_n": 8, "min_template_n": 1}


def full_template(template: str, h_change: Dict, charge_change: Dict,
                  chiral_change: Dict) -> str:
    """Template string + encoded H/charge/chirality deltas
    (reference get_templates.py:31-38)."""
    h_code = "".join(str(h_change[k + 1]) for k in range(len(h_change)))
    c_code = "".join(str(charge_change[k + 1]) for k in range(len(charge_change)))
    s_code = "".join(str(chiral_change[k + 1]) for k in range(len(chiral_change)))
    if s_code == "":
        return "_".join([template, h_code, c_code])
    return "_".join([template, h_code, c_code, s_code])


def canonical_product(smiles: str, engine: str = "auto"
                      ) -> Tuple[str, List[int]]:
    """Demap + canonicalize; returns (canonical smiles, original atom idx ->
    canonical atom idx) (reference get_templates.py:41-56)."""
    _native_engine(engine)
    from ..chem.canon import canonical_ranks, write_smiles
    from ..chem.mol import parse_smiles, remove_explicit_hydrogens
    # RDKit's MolFromSmiles strips removable explicit [H] atoms at parse
    # (removeHs default) — the extraction pipeline's atom numbering assumes
    # the same, so the native path must match or Labels/a2c would address
    # a different atom count
    mol = remove_explicit_hydrogens(parse_smiles(smiles))
    for a in mol.atoms:
        a.atom_map = 0
    ranks = canonical_ranks(mol)
    frag_outs = []
    for frag in mol.fragment_atom_sets():
        s, order = write_smiles(mol, rank_of=ranks, atom_subset=frag,
                                with_atom_order=True)
        frag_outs.append((s, order))
    frag_outs.sort(key=lambda t: t[0])  # canonical_smiles fragment order
    canon = ".".join(s for s, _ in frag_outs)
    perm = [i for _, order in frag_outs for i in order]
    orig2canon = [0] * len(perm)
    for canon_idx, orig_idx in enumerate(perm):
        orig2canon[orig_idx] = canon_idx
    return canon, orig2canon


class TemplateProcessor:
    """Two-pass LocalRetro-style preprocessing over train/val/test CSVs with
    a 'rxn_smiles' column of atom-mapped reactions."""

    def __init__(self, train_file: str, val_file: str, test_file: str,
                 output_path: str, settings: Optional[Dict] = None,
                 engine: str = "auto"):
        _native_engine(engine)
        self.engine = "native"
        self.files = {"train": train_file, "val": val_file, "test": test_file}
        self.output_path = output_path
        self.settings = {**PIPELINE_SETTINGS, **(settings or {})}
        os.makedirs(output_path, exist_ok=True)

    # -- reference Processor.check_data_format (get_templates.py:81-103) --
    def check_data_format(self, n_rows: int = 100) -> None:
        from ..chem.mol import parse_smiles as parse
        for fn in self.files.values():
            assert os.path.exists(fn), f"{fn} does not exist"
            with open(fn) as f:
                for i, row in enumerate(csv.DictReader(f)):
                    if i > n_rows:
                        break
                    assert "rxn_smiles" in row, f"{fn}: missing rxn_smiles"
                    reactants, _, products = row["rxn_smiles"].split(">")
                    # RDKit's MolFromSmiles returns None on bad input (the
                    # reference check ignores it); the stricter native
                    # parser raises — tolerate per-row, like the passes do
                    try:
                        parse(reactants)
                        parse(products)
                    except Exception as e:
                        log.warning("%s row %d: unparseable (%s)", fn, i, e)
        log.info("data format check passed")

    def run(self) -> None:
        self.extract_templates()
        self.match_templates()

    # ------------------------------------------------------------------
    def _read_rxns(self, split: str) -> List[str]:
        with open(self.files[split]) as f:
            return [row["rxn_smiles"].strip() for row in csv.DictReader(f)]

    def extract_templates(self) -> None:
        """Pass 1 (reference get_templates.py:140-217)."""
        outputs = ["template_infos.csv", "atom_templates.csv", "bond_templates.csv"]
        if all(os.path.exists(os.path.join(self.output_path, f)) for f in outputs):
            log.info("templates already extracted at %s", self.output_path)
            return
        rxns = self._read_rxns("train")
        edits_of: Dict[str, Dict] = {}
        h_of: Dict[str, Dict] = {}
        c_of: Dict[str, Dict] = {}
        s_of: Dict[str, Dict] = {}
        freq = defaultdict(int)
        atom_templates = defaultdict(int)
        bond_templates = defaultdict(int)

        for i, rxn in enumerate(rxns):
            try:
                result = extract_template(
                    {"reactants": rxn.split(">")[0],
                     "products": rxn.split(">")[-1], "_id": i},
                    self.settings, engine=self.engine)
                if "reaction_smarts" not in result:
                    continue
                chiral = result["Chiral_change"] if self.settings["use_stereo"] else {}
                key = full_template(result["reaction_smarts"],
                                    result["H_change"],
                                    result["Charge_change"], chiral)
                if key not in h_of:
                    edits_of[key] = {t: result["edits"][t][2]
                                     for t in result["edits"]}
                    h_of[key] = result["H_change"]
                    c_of[key] = result["Charge_change"]
                    s_of[key] = chiral
                freq[key] += 1
                for edit_type, payload in result["edits"].items():
                    if payload[0]:
                        if edit_type in ("A", "R"):
                            atom_templates[key] += 1
                        else:
                            bond_templates[key] += 1
            except Exception as e:
                log.info("extract failure at %d: %s", i, e)
            if i % 1000 == 0:
                log.info("extracted %d/%d: %d templates", i, len(rxns), len(freq))

        infos = Table.from_records([
            {"Template": k, "edit_site": edits_of[k], "change_H": h_of[k],
             "change_C": c_of[k], "change_S": s_of[k], "Frequency": freq[k]}
            for k in h_of])
        infos.to_csv(os.path.join(self.output_path, "template_infos.csv"),
                     index=True)
        for name, table in (("atom", atom_templates), ("bond", bond_templates)):
            path = os.path.join(self.output_path, f"{name}_templates.csv")
            with open(path, "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(["Template", "Frequency", "Class"])
                # class id = frequency-ascending position + 1
                # (reference get_templates.py:215-217)
                for cls, (tpl, n) in enumerate(
                        sorted(table.items(), key=lambda kv: kv[1]), start=1):
                    writer.writerow([tpl, n, cls])
        log.info("wrote %d templates (%d atom / %d bond)",
                 len(freq), len(atom_templates), len(bond_templates))

    # ------------------------------------------------------------------
    def match_templates(self) -> None:
        """Pass 2 (reference get_templates.py:219-406)."""
        tables = {}
        for site in ("atom", "bond"):
            path = os.path.join(self.output_path, f"{site}_templates.csv")
            with open(path) as f:
                tables[site] = {row["Template"].strip(): int(row["Class"])
                                for row in csv.DictReader(f)}
        with open(os.path.join(self.output_path, "template_infos.csv")) as f:
            infos = {row["Template"]: int(row["Frequency"])
                     for row in csv.DictReader(f)}

        dfs = {}
        for split in ("train", "val", "test"):
            rows = []
            success = 0
            rxns = self._read_rxns(split)
            for i, rxn in enumerate(rxns):
                reactant, _, product = rxn.split(">")
                record = {"Reactants": reactant, "Products": product,
                          "Reagents": "", "Labels": [], "Frequency": 0}
                canon, orig2canon = canonical_product(product, self.engine)
                record["ProductCanonSmiles"] = canon
                record["ProductAtomIdx2CanonIdx"] = orig2canon
                record["ProductCanonBonds"] = bonds_from_smiles(
                    canon, engine=self.engine)
                try:
                    result = extract_template(
                        {"reactants": reactant, "products": product, "_id": i},
                        self.settings, engine=self.engine)
                    key = full_template(result["reaction_smarts"],
                                        result["H_change"],
                                        result["Charge_change"],
                                        result["Chiral_change"])
                    record["Reactants"] = result["reactants"]
                    record["Products"] = result["products"]
                    record["Reagents"] = ".".join(result["necessary_reagent"])
                    canon, orig2canon = canonical_product(result["products"],
                                                          self.engine)
                    record["ProductAtomIdx2CanonIdx"] = orig2canon
                    if key in infos:
                        edits = {t: result["edits"][t][0]
                                 for t in result["edits"]}
                        edit_n = sum(len(v) / 2 if t == "C" else len(v)
                                     for t, v in edits.items())
                        if edit_n <= self.settings["max_edit_n"]:
                            labels = []
                            for edit_type, sites in edits.items():
                                cls_table = (tables["atom"]
                                             if edit_type in ("A", "R")
                                             else tables["bond"])
                                kind = "a" if edit_type in ("A", "R") else "b"
                                for site in sites:
                                    labels.append((kind, site, cls_table[key]))
                            record["Labels"] = labels
                            record["Frequency"] = infos[key]
                            success += 1
                        else:
                            log.info("reaction %d: too many edits (%s)", i, edit_n)
                except Exception as e:
                    log.info("match failure at %d: %s", i, e)
                rows.append(record)
            log.info("%s: templates cover %.3f of reactions", split,
                     success / max(len(rxns), 1))
            df = Table.from_records(rows)
            df.to_csv(os.path.join(self.output_path,
                                   f"preprocessed_{split}.csv"), index=True)
            dfs[split] = df

        self._write_simulate_output(dfs["test"])
        for split, df in dfs.items():
            df["Split"] = [split] * len(df)
        combined = concat(list(dfs.values()))
        combined["Mask"] = [int(f >= self.settings["min_template_n"])
                            for f in combined["Frequency"]]
        combined.to_csv(os.path.join(self.output_path, "labeled_data.csv"))

    def _write_simulate_output(self, test_df: Table) -> None:
        """Gold-edit oracle file (reference get_templates.py:381-395)."""
        path = os.path.join(self.output_path, "simulate_output.txt")
        max_n = self.settings["max_edit_n"]
        with open(path, "w") as f:
            header = "\t".join(f"Edit {i+1}\tProba {i+1}" for i in range(max_n))
            f.write(f"Test_id\tReactant\tProduct\t{header}\n")
            for i in range(len(test_df)):
                labels = [y for y in test_df["Labels"][i] if y != 0] or [(0, 0)]
                cells = "\t".join(f"{l}\t{1.0}" for l in labels)
                f.write(f"{i}\t{test_df['Reactants'][i]}\t"
                        f"{test_df['Products'][i]}\t{cells}\n")


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    p = argparse.ArgumentParser(prog="textreact_tpu_torch.templates")
    p.add_argument("--train_file", required=True)
    p.add_argument("--valid_file", required=True)
    p.add_argument("--test_file", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--engine", default="auto",
                   choices=("auto", "rdkit", "native"))
    args = p.parse_args(argv)
    proc = TemplateProcessor(args.train_file, args.valid_file, args.test_file,
                             args.output_path, engine=args.engine)
    proc.check_data_format()
    proc.run()


if __name__ == "__main__":
    main()
