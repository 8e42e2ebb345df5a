"""WordPiece text tokenizer (BERT-uncased style), implemented from scratch.

The reference delegates paragraph-text tokenization to a pretrained HF
AutoTokenizer (SciBERT uncased, reference tokenizer.py:283-288). This module
implements the standard BERT basic+WordPiece algorithm natively so the
framework has no HF dependency; point it at any BERT-format vocab.txt
(e.g. the SciBERT scivocab) for checkpoint-compatible ids.
"""

from __future__ import annotations

import unicodedata
from typing import List, Optional

from .base import BaseTokenizer, Encoding
from .vocab import Vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric ranges are treated as punctuation (^, $, ` included).
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


# ASCII fast path for _clean: \t\n\r and space map to " ", other control
# chars (<0x20, 0x7F) are deleted, everything else passes through — exactly
# the per-char unicode-category path restricted to ASCII inputs.
_ASCII_CLEAN = {cp: (" " if chr(cp) in " \t\n\r" else
                     (None if cp < 32 or cp == 127 else chr(cp)))
                for cp in range(128)}


class BasicTextTokenizer:
    """Cleanup + lowercase + accent-strip + punctuation/CJK splitting."""

    def __init__(self, lower_case: bool = True):
        self.lower_case = lower_case
        # raw word -> basic tokens; natural text is Zipfian, so this makes
        # repeat tokenization a dict lookup (bounded; see _CACHE_CAP)
        self._word_cache: dict = {}

    _CACHE_CAP = 1 << 18

    def tokenize(self, text: str) -> List[str]:
        if text.isascii():
            text = text.translate(_ASCII_CLEAN)
            # ASCII has no CJK: skip _pad_cjk
        else:
            text = self._clean(text)
            text = self._pad_cjk(text)
        tokens: List[str] = []
        cache = self._word_cache
        for word in text.split():
            hit = cache.get(word)
            if hit is None:
                w = word
                if self.lower_case:
                    w = self._strip_accents(w.lower())
                hit = self._split_punct(w)
                if len(cache) < self._CACHE_CAP:
                    cache[word] = hit
            tokens.extend(hit)
        return tokens

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _pad_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(word: str) -> List[str]:
        pieces: List[str] = []
        current: List[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    pieces.append("".join(current))
                    current = []
                pieces.append(ch)
            else:
                current.append(ch)
        if current:
            pieces.append("".join(current))
        return pieces


class WordPieceTokenizer(BaseTokenizer):
    """Greedy longest-match-first WordPiece over basic tokens."""

    cls_token = "[CLS]"
    sep_token = "[SEP]"

    def __init__(self, vocab_file: str, lower_case: bool = True,
                 max_chars_per_word: int = 100, native: bool = True):
        self.vocab = Vocab.from_file(vocab_file, self.unk_token)
        self.basic = BasicTextTokenizer(lower_case=lower_case)
        self.max_chars_per_word = max_chars_per_word
        self._piece_cache: dict = {}  # basic token -> wordpiece list
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

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        tokens: List[str] = []
        cache = self._piece_cache
        for word in self.basic.tokenize(text):
            hit = cache.get(word)
            if hit is None:
                hit = self.wordpiece(word)
                if len(cache) < BasicTextTokenizer._CACHE_CAP:
                    cache[word] = hit
            tokens.extend(hit)
        return tokens

    def __call__(self, text: str) -> Encoding:
        body = None
        if self._native is not None:
            # C++ twin (tokenizers/_ctok.cpp), the same ids on ASCII text;
            # None for non-ASCII text, which takes the Python route
            body = self._native.encode(text, self.max_chars_per_word,
                                       self.basic.lower_case)
        if body is None:
            body = self.convert_tokens_to_ids(self.tokenize(text))
        ids = [self.cls_token_id] + body + [self.sep_token_id]
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    def decode(self, ids: List[int], skip_special_tokens: bool = True) -> str:
        specials = {self.pad_token, self.cls_token, self.sep_token, self.mask_token}
        words: List[str] = []
        for i in ids:
            tok = self.vocab.token(i)
            if skip_special_tokens and tok in specials:
                continue
            if tok.startswith("##") and words:
                words[-1] += tok[2:]
            else:
                words.append(tok)
        return " ".join(words)


def make_text_tokenizer(vocab_file: Optional[str]) -> WordPieceTokenizer:
    """Build the text tokenizer from a BERT-format vocab file. A local SciBERT
    vocab path reproduces the reference's pretrained-tokenizer ids."""
    if vocab_file is None:
        raise ValueError(
            "Text tokenization needs a WordPiece vocab file "
            "(e.g. SciBERT scivocab vocab.txt); pass --text_vocab_file.")
    return WordPieceTokenizer(vocab_file)
