"""Joint SMILES+text encoder tokenizer.

Parity with reference textreact/tokenizer.py:232-275 (SmilesTextTokenizer):
the encoder input is `SMILES ++ neighbor paragraphs`, where in 'smiles_text'
mode the SMILES ids are shifted by the text-vocab size so both vocabularies
coexist in one embedding table, and each appended text segment drops its
leading [CLS].

(The reference's `__len__` double-counts the text vocab in text-only mode
because of an `is not None` check on a bool, tokenizer.py:247-251; here the
offset is 0 and len == len(text vocab) when no separate smiles tokenizer is
used, which is the semantics the rest of the reference relies on.)
"""

from __future__ import annotations

from typing import List, Union

from .base import BaseTokenizer, Encoding


class JointSmilesTextTokenizer(BaseTokenizer):
    def __init__(self, text_tokenizer, smiles_tokenizer=None):
        self.text_tokenizer = text_tokenizer
        self.smiles_tokenizer = smiles_tokenizer or text_tokenizer
        self.separate = smiles_tokenizer is not None

    @property
    def smiles_offset(self) -> int:
        return len(self.text_tokenizer) if self.separate else 0

    def __len__(self) -> int:
        return len(self.text_tokenizer) + (len(self.smiles_tokenizer) if self.separate else 0)

    @property
    def pad_token_id(self) -> int:
        return self.text_tokenizer.pad_token_id

    @property
    def mask_token_id(self) -> int:
        return self.text_tokenizer.mask_token_id

    def __call__(self, smiles: str, text_pair: Union[str, List[str], None] = None) -> Encoding:
        result = self.smiles_tokenizer(smiles)
        if self.separate:
            result["input_ids"] = [i + self.smiles_offset for i in result["input_ids"]]
        if text_pair is None:
            return result
        pairs = [text_pair] if isinstance(text_pair, str) else list(text_pair)
        for t in pairs:
            enc = self.text_tokenizer(t)
            for key in result:
                result[key] = result[key] + enc[key][1:]  # drop the segment's [CLS]
        return result

    def convert_id_to_token(self, idx: int) -> str:
        if idx < len(self.text_tokenizer):
            return self.text_tokenizer.vocab.token(idx)
        return self.smiles_tokenizer.vocab.token(idx - len(self.text_tokenizer))

    def decode(self, ids: List[int], skip_special_tokens: bool = False) -> str:
        if not self.separate:
            return self.text_tokenizer.decode(ids, skip_special_tokens=skip_special_tokens)
        out: List[str] = []
        boundary = len(self.text_tokenizer)
        for i in ids:
            tok = self.convert_id_to_token(i)
            if i >= boundary:
                out.append(tok)
            else:
                if tok.startswith("##") and out:
                    out[-1] += tok[2:]
                else:
                    out.append(" " + tok)
        return "".join(out).strip()
