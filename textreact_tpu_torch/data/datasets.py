"""Task datasets: reaction-condition recommendation and retrosynthesis (own
copy of textreact_tpu/data/datasets.py over utils/table.py).

Parity: reference textreact/dataset.py:21-284 (BaseDataset,
ReactionConditionDataset, RetrosynthesisDataset). Examples are produced as
plain dicts of python lists; the collator (collate.py) turns them into
fixed-shape numpy batches.

Randomness design: every stochastic choice (neighbor sampling,
SMILES shuffling, MLM masking) happens host-side through an explicit
`random.Random` handed in per example — device graphs stay deterministic and
an (seed, epoch, index) triple reproduces any example.

Known divergence from the reference, by design (as in the JAX package):
atom string-positions for the template-based path account for the leading
[CLS] token (+1 shift). The reference indexes encoder states with raw token
positions (dataset.py:237-240 feeding model.py:59-62), silently reading
each atom's state one position to the left; here the gather lands on the
atom's own token.
"""

from __future__ import annotations

import random as _random
from typing import Any, Dict, List, Optional

import numpy as np

from ..chem import random_smiles
from ..config import ExperimentConfig
from ..tokenizers import atom_token_positions
from ..utils.table import read_csv
from .corpus import CONDITION_COLS, read_neighbors
from .mlm import apply_span_mlm, remap_positions
from .neighbors import (format_neighbor_text, select_neighbor_texts,
                        window_neighbor_texts)

Example = Dict[str, Any]


def random_shuffle_reaction_smiles(rxn_smiles: str, rng: _random.Random,
                                   p: float = 0.8) -> str:
    """Shuffle fragment order and randomize each fragment's atom order
    (reference dataset.py:432-442)."""
    if rng.random() > p:
        return rxn_smiles
    if ">>" not in rxn_smiles:
        return rxn_smiles
    reactant_str, product_str = rxn_smiles.split(">>")
    reactants = [random_smiles(s, rng)[0] for s in reactant_str.split(".")]
    products = [random_smiles(s, rng)[0] for s in product_str.split(".")]
    rng.shuffle(reactants)
    rng.shuffle(products)
    return ".".join(reactants) + ">>" + ".".join(products)


class BaseDataset:
    def __init__(self, cfg: ExperimentConfig, data_file: str, enc_tokenizer,
                 dec_tokenizer, split: str = "train"):
        self.cfg = cfg
        self.enc_tokenizer = enc_tokenizer
        self.dec_tokenizer = dec_tokenizer
        self.data_df = read_csv(data_file)
        if split == "train" and cfg.num_train_example is not None:
            self.data_df = self.data_df.head(cfg.num_train_example)
        self.indices: List[str] = list(self.data_df["id"])
        self.corpus: Optional[Dict[str, str]] = None
        self.neighbors: Optional[Dict[str, List[str]]] = None
        self.skip_gold_neighbor = False
        self.split = split
        self.name = split

    def __len__(self) -> int:
        return len(self.data_df)

    def _row_idx(self, idx: int) -> int:
        return idx

    def load_corpus(self, corpus: Dict[str, str], nn_file: str) -> None:
        self.corpus = corpus
        self.neighbors = read_neighbors(nn_file)

    def with_skip_gold(self) -> "BaseDataset":
        """Shallow eval-twin retrieving from the gold-removed corpus
        (reference main.py:336-340)."""
        import copy
        twin = copy.copy(self)
        twin.skip_gold_neighbor = True
        return twin

    # ---- neighbor text -----------------------------------------------------
    def neighbor_text(self, idx: int, rng: _random.Random) -> Optional[str]:
        if self.cfg.num_neighbors <= 0 or self.corpus is None:
            return None
        rxn_id = self.indices[idx]
        texts = select_neighbor_texts(
            rxn_id, self.neighbors[rxn_id], self.corpus,
            split=self.split,
            num_neighbors=self.cfg.num_neighbors,
            max_num_neighbors=self.cfg.max_num_neighbors,
            use_gold_neighbor=self.cfg.use_gold_neighbor,
            random_neighbor_ratio=self.cfg.random_neighbor_ratio,
            skip_gold_neighbor=self.skip_gold_neighbor,
            rng=rng,
        )
        return format_neighbor_text(texts)

    # ---- per-example assembly ---------------------------------------------
    def example(self, idx: int, rng: Optional[_random.Random] = None,
                augment: Optional[bool] = None) -> Example:
        """Build one training/eval example (reference dataset.py:130-145)."""
        rng = rng or _random.Random(0)
        if augment is None:
            augment = self.split == "train"
        enc_input = self.prepare_encoder_input(idx, rng, augment)
        enc_input = {k: self._truncate(v, k) for k, v in enc_input.items()}
        out: Example = {"id": self.indices[self._row_idx(idx)], "index": idx}
        if self.cfg.mlm and self.split == "train" and augment:
            ids, position_ids, mlm_labels = apply_span_mlm(
                enc_input["input_ids"], self.enc_tokenizer.mask_token_id,
                self.cfg.mlm_ratio, rng=rng)
            if "atom_indices" in enc_input:
                enc_input["atom_indices"] = remap_positions(
                    position_ids, enc_input["atom_indices"])
            enc_input["input_ids"] = ids
            enc_input["position_ids"] = position_ids
            out["mlm_labels"] = mlm_labels
        dec_input = self.prepare_decoder_input(idx)
        if not self.cfg.template_based:
            dec_input = {k: v[: self.cfg.max_dec_length] for k, v in dec_input.items()}
        out.update(enc_input)
        out.update({f"decoder_{k}": v for k, v in dec_input.items()})
        return out

    def _truncate(self, value, name: str):
        L = self.cfg.max_length
        if name in ("atom_indices", "bonds"):
            return value
        if isinstance(value, np.ndarray) and value.ndim == 2:
            return value[:L, :L]    # the bond mask
        return value[:L]

    def prepare_encoder_input(self, idx: int, rng: _random.Random, augment: bool) -> Example:
        raise NotImplementedError

    def prepare_decoder_input(self, idx: int) -> Example:
        raise NotImplementedError


class ConditionDataset(BaseDataset):
    """RCR task (reference dataset.py:171-192)."""

    def prepare_encoder_input(self, idx, rng, augment):
        row = self.data_df.row(idx)
        rxn_smiles = "" if self.cfg.no_smiles else row["canonical_rxn"]
        if augment and self.cfg.shuffle_smiles:
            rxn_smiles = random_shuffle_reaction_smiles(rxn_smiles, rng)
        nn_text = self.neighbor_text(idx, rng)
        return dict(self.enc_tokenizer(rxn_smiles, text_pair=nn_text))

    def prepare_decoder_input(self, idx):
        if self.split == "test":
            return {}
        row = self.data_df.row(idx)
        conditions = [row[c] for c in CONDITION_COLS]
        return dict(self.dec_tokenizer(conditions))


class RetrosynthesisDataset(BaseDataset):
    """Retro task, template-free or template-based
    (reference dataset.py:195-284)."""

    def __init__(self, cfg, data_file, enc_tokenizer, dec_tokenizer, split="train"):
        super().__init__(cfg, data_file, enc_tokenizer, dec_tokenizer, split=split)
        self.template_based = cfg.template_based
        if self.template_based:
            from .templates import load_preprocessed_labels
            (self.template_data, self.product_atomidx2canonidx,
             self.product_canon_bonds) = load_preprocessed_labels(
                cfg.template_path, split)

    def __len__(self):
        if self.split == "test" and self.cfg.test_each_neighbor:
            return len(self.data_df) * self.cfg.test_num_neighbors
        return len(self.data_df)

    def _row_idx(self, idx: int) -> int:
        if self.split == "test" and self.cfg.test_each_neighbor:
            return idx // self.cfg.test_num_neighbors
        return idx

    def neighbor_text(self, idx, rng):
        if self.split == "test" and self.cfg.test_each_neighbor:
            rxn_id = self.indices[self._row_idx(idx)]
            texts = window_neighbor_texts(
                self.neighbors[rxn_id], self.corpus,
                nn_offset=idx % self.cfg.test_num_neighbors,
                num_neighbors=self.cfg.num_neighbors)
            return format_neighbor_text(texts)
        return super().neighbor_text(idx, rng)

    def example(self, idx, rng=None, augment=None):
        out = super().example(idx, rng, augment)
        # predictions are keyed by integer example index (reference keys its
        # output dicts the same way, main.py:186,229-233); in
        # test_each_neighbor mode that index is the expanded one, aggregated
        # later by idx // test_num_neighbors (reference utils.py:55-64)
        out["id"] = self.indices[self._row_idx(idx)]
        return out

    def prepare_encoder_input(self, idx, rng, augment):
        row = self.data_df.row(self._row_idx(idx))
        product_smiles = row["product_smiles"]
        atom_permutation = None
        if augment and self.cfg.shuffle_smiles:
            product_smiles, atom_permutation = random_smiles(product_smiles, rng)
        if self.cfg.no_smiles:
            product_smiles = ""
        nn_text = self.neighbor_text(idx, rng)
        enc_input = dict(self.enc_tokenizer(product_smiles, text_pair=nn_text))
        if self.template_based:
            # string position of each atom token; +1 accounts for [CLS]
            enc_input["atom_indices"] = [i + 1 for i in atom_token_positions(product_smiles)]
            enc_input["bonds"] = self.product_canon_bonds[self._row_idx(idx)]
            if atom_permutation is not None:
                permuted = [0] * len(enc_input["atom_indices"])
                for new_atom_idx, old_atom_idx in enumerate(atom_permutation):
                    permuted[old_atom_idx] = enc_input["atom_indices"][new_atom_idx]
                enc_input["atom_indices"] = permuted
            if self.cfg.unattend_nonbonds:
                enc_input["attention_mask"] = self._bond_mask(enc_input)
        return enc_input

    @staticmethod
    def _bond_mask(enc_input) -> np.ndarray:
        """2-D attention mask, (L, L) int32: non-bonded atom pairs cannot
        attend (reference dataset.py:247-254). The JAX package builds the
        same values as lists of L ints a row, which at L = 512 costs the
        loader more than the device's step; here the atoms' block is set
        in one assignment."""
        seq_len = len(enc_input["attention_mask"])
        mask = np.ones((seq_len, seq_len), np.int32)
        pos = np.asarray(enc_input["atom_indices"], np.int64)
        n = len(pos)
        keep = np.eye(n, dtype=np.int32)
        bonds = np.asarray(enc_input["bonds"], np.int64).reshape(-1, 2)
        bonds = bonds[(bonds >= 0).all(1) & (bonds < n).all(1)]
        keep[bonds[:, 0], bonds[:, 1]] = 1
        mask[np.ix_(pos, pos)] = keep
        return mask

    def prepare_decoder_input(self, idx):
        if self.template_based:
            row_idx = self._row_idx(idx)
            a2c = self.product_atomidx2canonidx[row_idx]
            raw, a_locs, a_ids, b_locs, b_ids = [], [], [], [], []
            for ttype, tloc, tid in self.template_data[row_idx]:
                tloc = a2c[tloc] if ttype == "a" else tuple(a2c[l] for l in tloc)
                raw.append((ttype, tloc, tid))
                if ttype == "a":
                    a_locs.append(tloc)
                    a_ids.append(tid)
                else:
                    b_locs.append(tloc)
                    b_ids.append(tid)
            return {"raw_template_labels": raw,
                    "atom_template_locs": a_locs, "atom_template_ids": a_ids,
                    "bond_template_locs": b_locs, "bond_template_ids": b_ids}
        if self.split == "test":
            return {}
        row = self.data_df.row(self._row_idx(idx))
        return dict(self.dec_tokenizer(row["reactant_smiles"]))


def gather_prediction_each_neighbor(prediction: Dict[int, Dict[str, Any]],
                                    num_neighbors: int
                                    ) -> Dict[int, Dict[str, Any]]:
    """Merge per-neighbor test predictions: expanded index i maps to example
    i // num_neighbors, concatenating prediction/score lists
    (reference utils.py:55-64; textreact_tpu/evaluation/__init__.py)."""
    results: Dict[int, Dict[str, Any]] = {}
    for i, pred in sorted(prediction.items()):
        idx = i // num_neighbors
        if i % num_neighbors == 0:
            results[idx] = dict(pred)
        else:
            for key in results[idx]:
                results[idx][key] = results[idx][key] + pred[key]
    return results


DATASET_CLS = {
    "condition": ConditionDataset,
    "retro": RetrosynthesisDataset,
}
