"""Offline data curation (one-shot): corpus tools, splits, matching,
augmentation, baselines. Own copy of textreact_tpu/preprocess/ over
utils/table.py: the same names, and the same files written, without pandas.

The upstream raw-USPTO condition-extraction stages (XML parsing via
xmltodict, atom re-mapping via rxnmapper — reference
preprocess/uspto_script/1.*-3.* scripts) consume services not present in
this environment; this package implements every downstream stage from the
extracted condition CSVs onward.
"""

from .augment import augment_condition_train
from .condition_splits import (condition_vocab, random_split_no_overlap,
                               time_split, write_vocab)
from .corpus_tools import (add_corpus_id_column, dedup_corpus,
                           grant_only_corpus, write_id_map)
from .frequency_baseline import (dummy_predictions, frequency_baseline_accuracy,
                                 top_condition_tuples)
from .retro_tools import (canonical_rxn_smiles, match_to_corpus,
                          reaction_similarity, year_resplit)

__all__ = [
    "augment_condition_train", "condition_vocab", "random_split_no_overlap",
    "time_split", "write_vocab", "add_corpus_id_column", "dedup_corpus",
    "grant_only_corpus", "write_id_map", "dummy_predictions",
    "frequency_baseline_accuracy", "top_condition_tuples",
    "canonical_rxn_smiles", "match_to_corpus", "reaction_similarity",
    "year_resplit",
]
