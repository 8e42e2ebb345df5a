"""The traffic of the template-based training cells: a mix's parameters
(`portbench/traffic/<name>.json`, kind `train_template`) made into a pool
of optimizer steps from the seed, as collated numpy arrays.

A prompt is a product's SMILES tokens, then its neighbours' text, cut at
the prompt length: [CLS] product [SEP] paragraph [SEP] ... [SEP], the
product's tokens and specials from the SMILES part of the joint
vocabulary, the paragraphs' from the text part (the port's
`JointSmilesTextTokenizer` in 'smiles_text' mode). A product of n heavy
atoms takes `tokens_per_atom` x n tokens; its atoms sit at n of them, the
first token always one, one past [CLS] (the dataset's `atom_indices`).
Its bonds are a spanning tree and `rings` ring closures, listed as the
dataset lists them: every bond both ways, sorted. Each example's (L, L)
attention mask follows `RetrosynthesisDataset._bond_mask`: ones, with the
atoms' block kept to each atom itself and the atoms it is bonded to. Under
MLM (`traffic.span_mlm`, masked tokens moved first) the atom indices move
with their tokens and the mask keeps the unmoved positions, as the
dataset's does.

Template labels: `labels.atoms` atoms and `labels.bonds` bonds of each
product (one way) carry a template id; the other atoms and bonds are class
0, the padding IGNORE_INDEX (the collator's rule).

Every seed gets the same shapes: each micro-batch takes its atom counts
from a grid over `product.atoms` and its ring counts cycled over
`product.rings` along that grid, so its widest product, and with it the
padded atom and bond axes, are fixed; the seed draws the tokens, the atom
positions, the bonds, the labels, the spans and the order.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import traffic

IGNORE_INDEX = traffic.IGNORE_INDEX


def sizes(mix: dict, n: int) -> tuple:
    """(atom counts, ring counts) of a micro-batch of n products."""
    lo, hi = mix["product"]["atoms"]
    atoms = traffic._grid(lo, hi, n)
    r_lo, r_hi = mix["product"]["rings"]
    rings = r_lo + np.arange(n) % (r_hi - r_lo + 1)
    return atoms, rings


def bond_mask(length: int, atoms: np.ndarray, bonds: np.ndarray
              ) -> np.ndarray:
    """(length, length) int32: every pair admitted but among atoms, where
    an atom (at position atoms[i]) admits itself and its bonded atoms."""
    mask = np.ones((length, length), np.int32)
    mask[np.ix_(atoms, atoms)] = 0
    mask[atoms, atoms] = 1
    mask[atoms[bonds[:, 0]], atoms[bonds[:, 1]]] = 1
    return mask


def _bonds(rng: np.random.Generator, n: int, rings: int) -> np.ndarray:
    """A spanning tree over n atoms and `rings` closures between atoms not
    yet bonded, every bond both ways, sorted: (2 * bonds, 2)."""
    pairs = {(int(rng.integers(0, i)), i) for i in range(1, n)}
    while len(pairs) < n - 1 + rings:
        a, b = sorted(int(x) for x in rng.choice(n, 2, replace=False))
        pairs.add((a, b))
    both = sorted(pairs | {(b, a) for a, b in pairs})
    return np.array(both, np.int64).reshape(-1, 2)


def example(rng: np.random.Generator, n_atoms: int, n_rings: int,
            mix: dict, cfg: dict) -> dict:
    """One product with its text: the prompt before MLM (`row`), its atoms'
    positions before MLM (`atoms`), bonds (`bonds`), its mask, labels, and
    the arrays after MLM (`ids`, `pos`, `atom_indices`, `mlm_labels`)."""
    ids_of = cfg["encoder_ids"]
    L = mix["prompt"]["length"]
    seg = mix["product"]["tokens_per_atom"] * n_atoms
    row = rng.integers(ids_of["first_word"], ids_of["last_word"] + 1, L)
    row[0] = ids_of["cls"]
    row[1:1 + seg] = rng.integers(ids_of["first_atom_token"],
                                  ids_of["vocab_size"], seg)
    row[1 + seg] = ids_of["sep"]
    # the paragraphs share what is left, each closed by the text [SEP]
    ends = np.linspace(1 + seg, L - 1, mix["prompt"]["neighbors"] + 1)
    row[np.round(ends[1:]).astype(int)] = ids_of["text_sep"]
    atoms = 1 + np.concatenate(
        [[0], np.sort(rng.choice(np.arange(1, seg), n_atoms - 1,
                                 replace=False))]).astype(np.int64)
    bonds = _bonds(rng, n_atoms, n_rings)
    mask = bond_mask(L, atoms, bonds)
    spec = mix["labels"]
    atom_labels = np.zeros(n_atoms, np.int64)
    k = rng.integers(spec["atoms"][0], spec["atoms"][1] + 1)
    atom_labels[rng.choice(n_atoms, k, replace=False)] = rng.integers(
        1, cfg["num_atom_templates"] + 1, k)
    bond_labels = np.zeros(len(bonds), np.int64)
    one_way = np.flatnonzero(bonds[:, 0] < bonds[:, 1])
    k = rng.integers(spec["bonds"][0], spec["bonds"][1] + 1)
    bond_labels[rng.choice(one_way, k, replace=False)] = rng.integers(
        1, cfg["num_bond_templates"] + 1, k)
    out = {"row": row, "atoms": atoms, "bonds": bonds, "mask": mask,
           "atom_labels": atom_labels, "bond_labels": bond_labels}
    if mix.get("mlm"):
        ids, pos, labels = traffic.span_mlm(rng, row, mix["mlm"],
                                            ids_of["mask"])
        new_at = np.empty(L, np.int64)
        new_at[pos] = np.arange(L)
        out.update(ids=ids, pos=pos, atom_indices=new_at[atoms],
                   mlm_labels=labels)
    else:
        out.update(ids=row, pos=np.arange(L), atom_indices=atoms)
    return out


def _width(n: int) -> int:
    """The collator's padded atom or bond axis: a multiple of 8, at least
    8."""
    return max(8, -(-n // 8) * 8)


def collate(rows: List[dict], cfg: dict) -> Dict[str, np.ndarray]:
    """The arrays of one micro-batch that the template step reads, padded
    as the port's collator pads them."""
    B = len(rows)
    L = traffic.bucket(max(len(r["ids"]) for r in rows),
                       cfg["length_buckets"])
    A = _width(max(len(r["atoms"]) for r in rows))
    MB = _width(max(len(r["bonds"]) for r in rows))
    out = {
        "input_ids": traffic._pad([r["ids"] for r in rows], L,
                                  cfg["encoder_ids"]["pad"]),
        "attention_mask": np.zeros((B, L, L), np.int32),
        "position_ids": traffic._pad([r["pos"] for r in rows], L, 0),
        "atom_indices": traffic._pad([r["atom_indices"] for r in rows], A,
                                     0),
        "bond_pairs": np.zeros((B, MB, 2), np.int32),
        "atom_template_labels": traffic._pad(
            [r["atom_labels"] for r in rows], A, IGNORE_INDEX),
        "bond_template_labels": traffic._pad(
            [r["bond_labels"] for r in rows], MB, IGNORE_INDEX),
    }
    for i, r in enumerate(rows):
        n = len(r["ids"])
        out["attention_mask"][i, :n, :n] = r["mask"]
        out["bond_pairs"][i, :len(r["bonds"])] = r["bonds"]
    if "mlm_labels" in rows[0]:
        max_m = max(len(r["mlm_labels"]) for r in rows)
        M = min(L, max(16, -(-max_m // 16) * 16))
        out["mlm_labels"] = traffic._pad([r["mlm_labels"] for r in rows], M,
                                         IGNORE_INDEX)
    return out


def pool(mix: dict, cfg: dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """`pool_steps` optimizer steps, each a dict of arrays stacked on a
    leading axis of `micro_batches` (one shape key a step)."""
    rng = np.random.default_rng(seed)
    B, n_micro = mix["micro_batch_size"], mix["micro_batches"]
    atoms, rings = sizes(mix, B)
    steps = []
    for _ in range(mix["pool_steps"]):
        micro = []
        for _ in range(n_micro):
            rows = [example(rng, int(atoms[i]), int(rings[i]), mix, cfg)
                    for i in rng.permutation(B)]
            micro.append(collate(rows, cfg))
        steps.append({k: np.stack([m[k] for m in micro]) for k in micro[0]})
    return [steps[i] for i in rng.permutation(len(steps))]
