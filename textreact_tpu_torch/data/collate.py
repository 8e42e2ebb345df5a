"""Collation into fixed-shape numpy batches (own copy of
textreact_tpu/data/collate.py).

Role of reference textreact/dataset.py:287-380 (DataCollator): instead of
padding to the ragged per-batch maximum, sequences pad to a small set of
LENGTH BUCKETS and the batch dimension pads to a fixed size, so a step sees
a handful of shapes in total (the fused attention kernel wants lengths that
are multiples of 128). Padded rows are flagged in `example_mask` and ignored
by loss/metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..config import bucket_length

IGNORE_INDEX = -100


@dataclasses.dataclass
class Batch:
    """Device-bound arrays plus host-only ragged fields."""
    arrays: Dict[str, np.ndarray]
    host: Dict[str, List[Any]]

    def __getitem__(self, key: str):
        return self.arrays[key] if key in self.arrays else self.host[key]

    def __contains__(self, key: str) -> bool:
        return key in self.arrays or key in self.host

    @property
    def size(self) -> int:
        return int(self.arrays["example_mask"].sum())


def _pad_1d(seqs: Sequence[Sequence[int]], length: int, pad: int,
            batch: int, dtype=np.int32) -> np.ndarray:
    out = np.full((batch, length), pad, dtype=dtype)
    for i, seq in enumerate(seqs):
        n = min(len(seq), length)
        out[i, :n] = seq[:n]
    return out


def _pad_2d(masks: Sequence, length: int, batch: int) -> np.ndarray:
    """Square (L, L) masks (arrays, or lists of rows) into one (batch,
    length, length) int32 array, zero-padded."""
    out = np.zeros((batch, length, length), dtype=np.int32)
    for i, m in enumerate(masks):
        m = np.asarray(m)
        n = min(len(m), length)
        out[i, :n, :n] = m[:n, :n]
    return out


class Collator:
    """static_shapes=True pads EVERY content-dependent dimension to its
    static cap (enc len -> max_length, dec len -> max_dec_length, mlm
    prefix -> enc len, atoms -> max_length, bonds -> 2*max_length). Needed
    for multi-process training: each host collates its own shard, and a
    batch shape derived from host-local content (length buckets, batch-max
    atom/bond counts) would differ across hosts. Single-host runs keep the
    bucketed shapes."""

    def __init__(self, cfg, enc_pad_id: int, dec_pad_id: int,
                 num_atom_templates: int = 0, num_bond_templates: int = 0,
                 static_shapes: bool = False):
        self.cfg = cfg
        self.enc_pad_id = enc_pad_id
        self.dec_pad_id = dec_pad_id
        self.num_atom_templates = num_atom_templates
        self.num_bond_templates = num_bond_templates
        self.static_shapes = static_shapes

    def __call__(self, examples: List[Dict[str, Any]],
                 fixed_batch: Optional[int] = None,
                 fixed_enc_len: Optional[int] = None,
                 fixed_dec_len: Optional[int] = None) -> Batch:
        cfg = self.cfg
        B = fixed_batch or len(examples)
        assert B >= len(examples)
        if self.static_shapes:
            fixed_enc_len = fixed_enc_len or cfg.max_length
            fixed_dec_len = fixed_dec_len or cfg.max_dec_length
        enc_lens = [len(ex["input_ids"]) for ex in examples]
        L = fixed_enc_len or bucket_length(
            min(max(enc_lens), cfg.max_length), tuple(b for b in cfg.length_buckets if b <= cfg.max_length) or (cfg.max_length,))

        arrays: Dict[str, np.ndarray] = {}
        host: Dict[str, List[Any]] = {}

        arrays["input_ids"] = _pad_1d([ex["input_ids"] for ex in examples], L,
                                      self.enc_pad_id, B)
        first_mask = examples[0]["attention_mask"]
        if np.ndim(first_mask[:1]) == 2:    # (L, L) bond masks
            arrays["attention_mask"] = _pad_2d(
                [ex["attention_mask"] for ex in examples], L, B)
        else:
            arrays["attention_mask"] = _pad_1d(
                [ex["attention_mask"] for ex in examples], L, 0, B)

        if "position_ids" in examples[0]:
            arrays["position_ids"] = _pad_1d(
                [ex.get("position_ids", list(range(len(ex["input_ids"]))))
                 for ex in examples], L, 0, B)

        if "mlm_labels" in examples[0]:
            if self.static_shapes:
                M = L
            else:
                max_m = max(len(ex["mlm_labels"]) for ex in examples)
                M = min(L, max(16, -(-max_m // 16) * 16))  # multiple of 16
            arrays["mlm_labels"] = _pad_1d(
                [ex["mlm_labels"] for ex in examples], M, IGNORE_INDEX, B)

        # --- seq2seq decoder ---
        if "decoder_input_ids" in examples[0]:
            dec_lens = [len(ex["decoder_input_ids"]) for ex in examples]
            Ld = fixed_dec_len or bucket_length(
                min(max(dec_lens), cfg.max_dec_length),
                tuple(b for b in cfg.dec_length_buckets if b <= cfg.max_dec_length) or (cfg.max_dec_length,))
            arrays["decoder_input_ids"] = _pad_1d(
                [ex["decoder_input_ids"] for ex in examples], Ld, self.dec_pad_id, B)
            arrays["decoder_attention_mask"] = _pad_1d(
                [ex["decoder_attention_mask"] for ex in examples], Ld, 0, B)

        # --- template-based labels (reference dataset.py:362-380) ---
        if "atom_indices" in examples[0]:
            num_atoms = [len(ex["atom_indices"]) for ex in examples]
            if self.static_shapes:
                A = -(-cfg.max_length // 8) * 8  # atoms are encoder positions
            else:
                A = max(8, -(-max(num_atoms) // 8) * 8)
            arrays["atom_indices"] = _pad_1d(
                [ex["atom_indices"] for ex in examples], A, 0, B)
            arrays["atom_mask"] = _pad_1d(
                [[1] * n for n in num_atoms], A, 0, B)
            host["bonds"] = [ex.get("bonds", []) for ex in examples]
            # Bond positions as an explicit pair list instead of a dense
            # (A, A) grid: the reference's loss ignores non-bond entries via
            # -100 labels (dataset.py:370-373) and its eval ranks only real
            # bonds (utils.py:87), so logits are only ever needed at bond
            # pairs. This turns O(A^2 * n_templates) logits into
            # O(num_bonds * n_templates).
            if self.static_shapes:
                MB = -(-(2 * cfg.max_length) // 8) * 8
            else:
                max_bonds = max((len(b) for b in host["bonds"]), default=0)
                MB = max(8, -(-max(max_bonds, 1) // 8) * 8)
            bond_pairs = np.zeros((B, MB, 2), dtype=np.int32)
            bond_mask = np.zeros((B, MB), dtype=np.int32)
            for i, bonds in enumerate(host["bonds"]):
                for j, pair in enumerate(bonds[:MB]):
                    bond_pairs[i, j] = pair
                    bond_mask[i, j] = 1
            arrays["bond_pairs"] = bond_pairs
            arrays["bond_mask"] = bond_mask
            if "decoder_atom_template_ids" in examples[0]:
                arrays["atom_template_labels"] = self._atom_labels(examples, num_atoms, A, B)
                arrays["bond_template_labels"] = self._bond_labels(
                    examples, host["bonds"], bond_pairs, bond_mask, B, MB)
                host["raw_template_labels"] = [ex["decoder_raw_template_labels"]
                                               for ex in examples]

        arrays["example_mask"] = np.array(
            [1] * len(examples) + [0] * (B - len(examples)), dtype=np.int32)
        arrays["indices"] = np.array(
            [ex["index"] for ex in examples] + [-1] * (B - len(examples)), dtype=np.int32)
        host["ids"] = [ex["id"] for ex in examples]
        return Batch(arrays=arrays, host=host)

    def _atom_labels(self, examples, num_atoms, A: int, B: int) -> np.ndarray:
        labels = np.full((B, A), IGNORE_INDEX, dtype=np.int32)
        for i, (ex, n) in enumerate(zip(examples, num_atoms)):
            labels[i, :n] = 0
            for loc, tid in zip(ex["decoder_atom_template_locs"],
                                ex["decoder_atom_template_ids"]):
                labels[i, loc] = tid
        return labels

    def _bond_labels(self, examples, bonds_list, bond_pairs: np.ndarray,
                     bond_mask: np.ndarray, B: int, MB: int) -> np.ndarray:
        """(B, MB) labels aligned with bond_pairs: 0 background, template id
        at labeled bond edits, IGNORE_INDEX on padded slots."""
        labels = np.full((B, MB), IGNORE_INDEX, dtype=np.int32)
        for i, (ex, bonds) in enumerate(zip(examples, bonds_list)):
            pair_slot = {tuple(p): j for j, p in enumerate(bonds[:MB])}
            labels[i, :len(bonds[:MB])] = 0
            for loc, tid in zip(ex["decoder_bond_template_locs"],
                                ex["decoder_bond_template_ids"]):
                slot = pair_slot.get(tuple(loc))
                if slot is not None:
                    labels[i, slot] = tid
        return labels
