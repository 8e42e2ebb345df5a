"""Fingerprint matrices for the retrieval engine (own copy of
textreact_tpu/retrieval/fingerprints.py; numpy only).

Role of reference retrieve/retrieve_faiss.py:18-50: reaction-difference
fingerprints for the RCR corpus ('canonical_rxn' field) and 1024-bit Morgan
fingerprints for retro ('product_smiles' field), via the chem kit (own
implementation; RDKit bridge when importable). Count vectors are clipped to
int8 so the kernel's integer products stay exact; clipping happens at build time on
both the index and query sides, so parity against the numpy oracle is over
identical vectors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..chem import fingerprint_matrix


def reaction_fingerprints(smiles_list: Sequence[str], n_bits: int = 2048,
                          num_workers: int = 0) -> np.ndarray:
    fps = fingerprint_matrix(smiles_list, kind="reaction", n_bits=n_bits,
                             num_workers=num_workers)
    return np.clip(fps, -127, 127).astype(np.int8)


def molecule_fingerprints(smiles_list: Sequence[str], n_bits: int = 1024,
                          num_workers: int = 0) -> np.ndarray:
    fps = fingerprint_matrix(smiles_list, kind="morgan", n_bits=n_bits,
                             num_workers=num_workers)
    return fps.astype(np.int8)


def tanimoto_similarities(query_fp: np.ndarray, corpus_fps: np.ndarray
                          ) -> np.ndarray:
    """Tanimoto similarity of one binary fingerprint against a matrix
    (role of reference retrieve/retrieve.py:32-69, the brute-force sanity
    path)."""
    inter = (corpus_fps & query_fp[None, :]).sum(axis=1).astype(np.float64)
    union = (corpus_fps | query_fp[None, :]).sum(axis=1).astype(np.float64)
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def count_tanimoto_similarities(query_fp: np.ndarray, corpus_fps: np.ndarray
                                ) -> np.ndarray:
    """Extended (real-valued) Tanimoto: q.c / (|q|^2 + |c|^2 - q.c) — the
    formula RDKit applies to count/difference fingerprints, used by the
    reference's brute-force reaction-similarity scan (retrieve.py:15-29).
    Handles the negative entries of difference fingerprints."""
    q = query_fp.astype(np.float64)
    c = corpus_fps.astype(np.float64)
    dot = c @ q
    denom = (q * q).sum() + (c * c).sum(axis=1) - dot
    return np.where(denom != 0, dot / np.where(denom == 0, 1, denom), 0.0)


def brute_force_rank(similarities: np.ndarray, top: int = 100):
    """Descending-similarity ranks (reference retrieve.py:56)."""
    order = np.argsort(similarities, kind="stable")[::-1][:top]
    return order.tolist(), [float(similarities[j]) for j in order]
