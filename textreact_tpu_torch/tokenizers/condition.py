"""Reaction-condition tokenizer: one token per whole molecule string.

Behavioral parity with reference textreact/tokenizer.py:20-59
(ReactionConditionTokenizer): the decoder vocabulary has 6 special tokens
([PAD],[BOS],[EOS],[MASK],[UNK],[SEP] at ids 0..5) followed by 308 condition
molecule SMILES strings; a 5-slot condition tuple encodes as
[BOS] c1 c2 c3 c4 c5 [EOS].
"""

from __future__ import annotations

from typing import List, Optional

from .base import BaseTokenizer, Encoding
from .vocab import CONDITION_VOCAB, Vocab


class ConditionTokenizer(BaseTokenizer):
    bos_token = "[BOS]"
    eos_token = "[EOS]"
    sep_token = "[SEP]"

    def __init__(self, vocab_file: Optional[str] = None):
        self.vocab = Vocab.from_file(vocab_file or CONDITION_VOCAB, self.unk_token)

    def __len__(self) -> int:
        return len(self.vocab)

    @property
    def bos_token_id(self) -> int:
        return self.vocab.get(self.bos_token)

    @property
    def eos_token_id(self) -> int:
        return self.vocab.get(self.eos_token)

    def __call__(self, conditions: List[str]) -> Encoding:
        """Encode a list of condition strings (e.g. the 5 slot values)."""
        ids = [self.bos_token_id] + self.convert_tokens_to_ids(conditions) + [self.eos_token_id]
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    def decode(self, ids: List[int], skip_special_tokens: bool = False) -> List[str]:
        """Decode ids to the list of condition tokens (reference returns a token
        list, not a joined string — evaluation compares lists elementwise)."""
        tokens = self.convert_ids_to_tokens(list(ids))
        if skip_special_tokens:
            specials = {self.pad_token, self.bos_token, self.eos_token,
                        self.mask_token, self.sep_token}
            tokens = [t for t in tokens if t not in specials]
        return tokens
