"""Data pipeline of the port: corpus IO, neighbor selection, MLM, datasets,
collation and the loader (own copies of textreact_tpu/data, over
utils/table.py in place of pandas)."""

from .collate import IGNORE_INDEX, Batch, Collator
from .corpus import (CONDITION_COLS, generate_train_label_corpus, read_corpus,
                     read_neighbors)
from .datasets import (DATASET_CLS, BaseDataset, ConditionDataset,
                       RetrosynthesisDataset, gather_prediction_each_neighbor,
                       random_shuffle_reaction_smiles)
from .loader import DataLoader, example_rng
from .mlm import apply_span_mlm, remap_positions, reorder_masked_first
from .neighbors import (deduplicate_by_text, format_neighbor_text,
                        select_neighbor_texts, window_neighbor_texts)
from .templates import (TemplateTables, load_preprocessed_labels,
                        load_template_tables)

__all__ = [
    "IGNORE_INDEX", "Batch", "Collator", "CONDITION_COLS",
    "generate_train_label_corpus", "read_corpus", "read_neighbors",
    "DATASET_CLS", "BaseDataset", "ConditionDataset", "RetrosynthesisDataset",
    "gather_prediction_each_neighbor", "random_shuffle_reaction_smiles",
    "DataLoader", "example_rng", "apply_span_mlm", "remap_positions",
    "reorder_masked_first", "deduplicate_by_text", "format_neighbor_text",
    "select_neighbor_texts", "window_neighbor_texts",
    "TemplateTables", "load_preprocessed_labels", "load_template_tables",
]
