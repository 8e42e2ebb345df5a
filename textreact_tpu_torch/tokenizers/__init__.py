"""Tokenizers for SMILES, condition vocab, paragraph text, and joint inputs
(own copies of textreact_tpu/tokenizers, token ids the same). The WordPiece
and SMILES tokenizers encode ASCII text through the C++ accelerator
(native.py + _ctok.cpp) unless built with `native=False`."""

from .base import BaseTokenizer, Encoding
from .condition import ConditionTokenizer
from .joint import JointSmilesTextTokenizer
from .smiles import (ATOM_REGEX, SMILES_REGEX_PATTERN, SmilesTokenizer,
                     atom_token_positions, tokenize_smiles)
from .text import BasicTextTokenizer, WordPieceTokenizer, make_text_tokenizer
from .vocab import CONDITION_VOCAB, SMILES_VOCAB, Vocab, load_vocab

__all__ = [
    "ATOM_REGEX", "SMILES_REGEX_PATTERN", "CONDITION_VOCAB", "SMILES_VOCAB",
    "BaseTokenizer", "Encoding", "Vocab", "load_vocab",
    "ConditionTokenizer", "SmilesTokenizer", "WordPieceTokenizer",
    "BasicTextTokenizer", "JointSmilesTextTokenizer",
    "tokenize_smiles", "atom_token_positions", "make_text_tokenizer",
    "get_tokenizers",
]


def get_tokenizers(cfg):
    """Build (encoder_tokenizer, decoder_tokenizer) from an ExperimentConfig.

    Mirrors reference textreact/tokenizer.py:278-305 (get_tokenizers): the
    encoder tokenizer is chosen by `encoder_tokenizer` in
    {'smiles','text','smiles_text'}; the decoder tokenizer by task
    ('condition' -> ConditionTokenizer, 'retro' -> SmilesTokenizer), or the
    (atom, bond) template tables for template-based retro.
    """
    mode = cfg.encoder_tokenizer
    if mode == "smiles":
        enc = SmilesTokenizer(cfg.vocab_file)
    elif mode == "text":
        enc = JointSmilesTextTokenizer(make_text_tokenizer(cfg.text_vocab_file))
    elif mode == "smiles_text":
        enc = JointSmilesTextTokenizer(
            make_text_tokenizer(cfg.text_vocab_file),
            SmilesTokenizer(cfg.vocab_file),
        )
    else:
        raise ValueError(f"unknown encoder_tokenizer: {mode!r}")

    if getattr(cfg, "template_based", False):
        if not mode.startswith("smiles"):
            raise ValueError("template-based retro requires a smiles encoder tokenizer")
        from ..data.templates import load_template_tables
        dec = load_template_tables(cfg.template_path)
    elif cfg.task == "condition":
        dec = ConditionTokenizer(cfg.vocab_file)
    elif cfg.task == "retro":
        dec = SmilesTokenizer(cfg.vocab_file)
    else:
        raise ValueError(f"unknown task: {cfg.task!r}")
    return enc, dec
