"""Minimal tokenizer base: encodings are plain dicts of python lists.

The framework deliberately does not depend on HF tokenizers; batches are
materialized as fixed-shape numpy arrays by the collator (data/collate.py),
which is where static shapes are enforced.
"""

from __future__ import annotations

from typing import Dict, List

Encoding = Dict[str, List[int]]


class BaseTokenizer:
    """Common special-token plumbing shared by all tokenizers."""

    pad_token = "[PAD]"
    unk_token = "[UNK]"
    mask_token = "[MASK]"

    def __len__(self) -> int:
        raise NotImplementedError

    # --- ids of special tokens (subclasses define the vocab attribute) ---
    @property
    def pad_token_id(self) -> int:
        return self.vocab.get(self.pad_token)

    @property
    def unk_token_id(self) -> int:
        return self.vocab.get(self.unk_token)

    @property
    def mask_token_id(self) -> int:
        return self.vocab.get(self.mask_token)

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        return [self.vocab.get(t) for t in tokens]

    def convert_ids_to_tokens(self, ids: List[int]) -> List[str]:
        return [self.vocab.token(i) for i in ids]
