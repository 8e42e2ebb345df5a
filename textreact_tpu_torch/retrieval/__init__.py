"""Exact retrieval engine (FAISS-flat parity) of the PyTorch port: twin of
textreact_tpu/retrieval."""

from .convert import convert_tevatron_jsonl
from .engine import FlatIndex, build_neighbor_file, merge_topk
from .fingerprints import (brute_force_rank, count_tanimoto_similarities,
                           molecule_fingerprints, reaction_fingerprints,
                           tanimoto_similarities)

__all__ = ["FlatIndex", "build_neighbor_file", "merge_topk",
           "convert_tevatron_jsonl", "molecule_fingerprints",
           "reaction_fingerprints", "tanimoto_similarities",
           "count_tanimoto_similarities", "brute_force_rank"]
