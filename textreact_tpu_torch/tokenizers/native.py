"""ctypes bridge to the C++ WordPiece and SMILES scanner (_ctok.cpp; twin
of textreact_tpu/tokenizers/native.py).

The library is built with g++ on first use into the package's build
directory (ops/_build.py::build_host); a failed build raises. Calls go
through `ctypes.CDLL`, which releases the interpreter lock for their
duration, so the loader's thread tokenizes while the launch loop runs. The
C++ path takes ASCII text only: `encode` returns None for text with
non-ASCII bytes, which the tokenizer then takes through its Python route,
so the ids are the same either way (tests/test_torch_native.py).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..ops._build import build_host

_SRC = Path(__file__).resolve().with_name("_ctok.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """The loaded library, built if missing or stale; raises if g++ fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_host(_SRC, "ctok")))
        lib.ctok_encoder_new.restype = ctypes.c_int32
        lib.ctok_encoder_new.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32]
        lib.ctok_encoder_free.restype = None
        lib.ctok_encoder_free.argtypes = [ctypes.c_int32]
        lib.ctok_encode.restype = ctypes.c_int32
        lib.ctok_encode.argtypes = [
            ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.ctok_smiles_encode.restype = ctypes.c_int32
        lib.ctok_smiles_encode.argtypes = [
            ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


class NativeWordPiece:
    """Handle to a C++ encoder over a fixed vocab. `encode` returns the
    wordpiece ids (no CLS/SEP) and `encode_smiles` the SMILES token ids, or
    None when the text has non-ASCII bytes and needs the Python route."""

    def __init__(self, token_to_id, unk_id: int):
        self._lib = get_lib()
        parts: List[bytes] = []
        offs = [0]
        ids: List[int] = []
        for tok, tid in token_to_id.items():
            b = tok.encode("utf-8")
            parts.append(b)
            offs.append(offs[-1] + len(b))
            ids.append(tid)
        offs_arr = (ctypes.c_int32 * len(offs))(*offs)
        ids_arr = (ctypes.c_int32 * len(ids))(*ids)
        self._handle = self._lib.ctok_encoder_new(
            b"".join(parts), offs_arr, ids_arr, len(ids), unk_id)
        # one output buffer per thread: the loader's thread and the main
        # thread may encode at once
        self._local = threading.local()

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.ctok_encoder_free(self._handle)

    def _buffer(self, grow: bool = False):
        buf = getattr(self._local, "buf", None)
        if buf is None or grow:
            buf = (ctypes.c_int32 * (2 * len(buf) if buf else 8192))()
            self._local.buf = buf
        return buf

    def _run(self, call) -> Optional[List[int]]:
        buf = self._buffer()
        while True:
            n = call(buf)
            if n == -1:  # the output did not fit: grow the buffer
                buf = self._buffer(grow=True)
                continue
            if n < 0:
                return None
            return np.frombuffer(buf, dtype=np.int32, count=n).tolist()

    def encode(self, text: str, max_chars_per_word: int = 100,
               lower: bool = True) -> Optional[List[int]]:
        if not text.isascii():
            return None
        raw = text.encode("ascii")
        return self._run(lambda buf: self._lib.ctok_encode(
            self._handle, raw, len(raw), max_chars_per_word, int(lower),
            buf, len(buf)))

    def encode_smiles(self, smiles: str) -> Optional[List[int]]:
        """Schwaller-regex SMILES scan + whole-token vocab lookup (the
        SmilesTokenizer algorithm); None for non-ASCII text."""
        if not smiles.isascii():
            return None
        raw = smiles.encode("ascii")
        return self._run(lambda buf: self._lib.ctok_smiles_encode(
            self._handle, raw, len(raw), buf, len(buf), None))
