"""SMILES tokenization: Schwaller regex pretokenizer + whole-token vocab lookup.

Parity targets: reference textreact/tokenizer.py:62-63 (regex pattern),
66-213 (SmilesTokenizer — regex tokens looked up whole against the vocab,
[CLS] ... [SEP] framing), 215-229 (BasicSmilesTokenizer).
"""

from __future__ import annotations

import re
from typing import List, Optional

from .base import BaseTokenizer, Encoding
from .vocab import SMILES_VOCAB, Vocab

# The Schwaller et al. SMILES tokenization regex (public domain pattern,
# same as reference tokenizer.py:62-63).
SMILES_REGEX_PATTERN = (
    r"(\[[^\]]+]|Br?|Cl?|N|O|S|P|F|I|b|c|n|o|s|p|\(|\)|\.|=|#"
    r"|-|\+|\\|\/|:|~|@|\?|>>?|\*|\$|\%[0-9]{2}|[0-9])"
)
_SMILES_REGEX = re.compile(SMILES_REGEX_PATTERN)

# Atom-token subset used to locate atom positions in the token stream
# (reference dataset.py:17).
ATOM_REGEX = re.compile(r"\[[^\]]+]|Br?|Cl?|N|O|S|P|F|I|b|c|n|o|s|p")


def tokenize_smiles(smiles: str) -> List[str]:
    """Split a SMILES string into chemistry-aware tokens."""
    return _SMILES_REGEX.findall(smiles)


def atom_token_positions(smiles: str) -> List[int]:
    """Indices (into the token stream) of tokens that denote atoms."""
    return [i for i, tok in enumerate(tokenize_smiles(smiles))
            if ATOM_REGEX.fullmatch(tok) is not None]


class SmilesTokenizer(BaseTokenizer):
    """Vocab tokenizer over regex SMILES tokens.

    bos=[CLS], eos=[SEP] as in the reference (tokenizer.py:85). Unknown regex
    tokens map to [UNK]; no sub-token wordpiece splitting is applied because
    the reference's `_tokenize` override bypasses wordpiece entirely
    (tokenizer.py:104-113).
    """

    cls_token = "[CLS]"
    sep_token = "[SEP]"

    def __init__(self, vocab_file: Optional[str] = None, native: bool = True):
        self.vocab = Vocab.from_file(vocab_file or SMILES_VOCAB, self.unk_token)
        self._native = None
        if native:
            from .native import NativeWordPiece
            self._native = NativeWordPiece(self.vocab.token_to_id,
                                           self.vocab.unk_id)

    def __len__(self) -> int:
        return len(self.vocab)

    @property
    def cls_token_id(self) -> int:
        return self.vocab.get(self.cls_token)

    @property
    def sep_token_id(self) -> int:
        return self.vocab.get(self.sep_token)

    # In seq2seq decoding the [CLS]/[SEP] ids play the bos/eos roles.
    @property
    def bos_token_id(self) -> int:
        return self.cls_token_id

    @property
    def eos_token_id(self) -> int:
        return self.sep_token_id

    def tokenize(self, smiles: str) -> List[str]:
        return tokenize_smiles(smiles)

    def __call__(self, smiles: str, text_pair: Optional[str] = None) -> Encoding:
        """[CLS] A [SEP] (+ B [SEP] for a pair, BERT-style — the reference's
        'smiles' encoder mode tokenizes any neighbor text with the same
        regex vocab, tokenizer.py:171-185)."""
        ids = [self.cls_token_id] + self._body(smiles) + [self.sep_token_id]
        if text_pair:
            ids += self._body(text_pair) + [self.sep_token_id]
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    def _body(self, smiles: str) -> List[int]:
        if self._native is not None:
            # C++ scanner (tokenizers/_ctok.cpp), the same ids on ASCII text
            ids = self._native.encode_smiles(smiles)
            if ids is not None:
                return ids
        return self.convert_tokens_to_ids(self.tokenize(smiles))

    def decode(self, ids: List[int], skip_special_tokens: bool = True) -> str:
        specials = {self.pad_token, self.cls_token, self.sep_token, self.mask_token}
        out = []
        for i in ids:
            tok = self.vocab.token(i)
            if skip_special_tokens and (tok in specials or tok.startswith("[unused")):
                continue
            out.append(tok)
        return "".join(out)
