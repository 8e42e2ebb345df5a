"""Vocabulary files: one token per line, id = line number.

Format parity with the reference vocab loader (reference textreact/tokenizer.py:9-17).
"""

from __future__ import annotations

import os
from typing import Dict, List

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")

CONDITION_VOCAB = os.path.join(_ASSET_DIR, "condition_vocab.txt")
SMILES_VOCAB = os.path.join(_ASSET_DIR, "smiles_vocab.txt")


def load_vocab(path: str) -> Dict[str, int]:
    """Load a one-token-per-line vocab file into {token: id}."""
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok in vocab:
                continue
            vocab[tok] = i
    return vocab


def save_vocab(tokens: List[str], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for tok in tokens:
            f.write(tok + "\n")


class Vocab:
    """Bidirectional token<->id map with an unk fallback."""

    def __init__(self, token_to_id: Dict[str, int], unk_token: str):
        self.token_to_id = dict(token_to_id)
        self.id_to_token = {i: t for t, i in token_to_id.items()}
        self.unk_token = unk_token
        self.unk_id = token_to_id[unk_token]

    @classmethod
    def from_file(cls, path: str, unk_token: str) -> "Vocab":
        return cls(load_vocab(path), unk_token)

    def __len__(self) -> int:
        return len(self.token_to_id)

    def __contains__(self, token: str) -> bool:
        return token in self.token_to_id

    def get(self, token: str) -> int:
        return self.token_to_id.get(token, self.unk_id)

    def token(self, idx: int) -> str:
        return self.id_to_token.get(idx, self.unk_token)
