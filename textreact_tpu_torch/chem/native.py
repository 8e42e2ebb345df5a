"""ctypes bridge to the C++ chemistry kernel (_cchem.cpp; twin of
textreact_tpu/chem/native.py): Morgan and reaction-difference fingerprints
and canonical SMILES, each the same as the Python implementation's
(tests/test_torch_native.py).

The library is built with g++ on first use into the package's build
directory (ops/_build.py::build_host); a failed build raises. Calls go
through `ctypes.CDLL`, which releases the interpreter lock.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..ops._build import build_host

_SRC = Path(__file__).resolve().with_name("_cchem.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """The loaded library, built if missing or stale; raises if g++ fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_host(_SRC, "cchem")))
        lib.cchem_morgan_fp.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32)]
        lib.cchem_morgan_fp.restype = ctypes.c_int
        lib.cchem_reaction_fp.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32)]
        lib.cchem_reaction_fp.restype = ctypes.c_int
        lib.cchem_morgan_fp_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int8)]
        lib.cchem_morgan_fp_batch.restype = None
        lib.cchem_canonical_smiles.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.cchem_canonical_smiles.restype = ctypes.c_int
        lib.cchem_canonical_smiles_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.cchem_canonical_smiles_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_morgan_fingerprint(smiles: str, radius: int = 2, n_bits: int = 1024,
                              counts: bool = False) -> np.ndarray:
    out = np.zeros((n_bits,), dtype=np.int32)
    get_lib().cchem_morgan_fp(
        smiles.encode(), radius, n_bits, int(counts),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out if counts else out.astype(np.uint8)


def native_reaction_fingerprint(rxn_smiles: str, radius: int = 2,
                                n_bits: int = 2048) -> np.ndarray:
    out = np.zeros((n_bits,), dtype=np.int32)
    rc = get_lib().cchem_reaction_fp(
        rxn_smiles.encode(), radius, n_bits,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise ValueError(f"not a reaction SMILES: {rxn_smiles!r}")
    return out


def native_morgan_batch(smiles_list: Sequence[str], radius: int = 2,
                        n_bits: int = 1024) -> np.ndarray:
    """Binary fingerprints of a list -> (N, n_bits) int8, in one C call."""
    blob = b"\x00".join(s.encode() for s in smiles_list) + b"\x00"
    out = np.zeros((len(smiles_list), n_bits), dtype=np.int8)
    get_lib().cchem_morgan_fp_batch(
        blob, len(smiles_list), radius, n_bits,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return out


def native_canonical_batch(smiles_list: Sequence[str]) -> List[str]:
    """Canonical SMILES of a list in one C call; an unparseable entry comes
    back verbatim (reference evaluate.py:27-32)."""
    if not smiles_list:
        return []
    blob = b"\x00".join(s.encode() for s in smiles_list) + b"\x00"
    cap = 4 * len(blob) + 64 * len(smiles_list)
    buf = ctypes.create_string_buffer(cap)
    n = get_lib().cchem_canonical_smiles_batch(blob, len(smiles_list), buf,
                                               cap)
    if n <= 0:
        raise RuntimeError("batch canonicalization overflowed its buffer")
    return bytes(buf.raw[:n - 1]).decode().split("\x00")


def native_canonical_smiles(smiles: str, fallback: Optional[str] = None) -> str:
    """Canonical SMILES (the same as chem.canonical_smiles_strict); on a
    parse failure `fallback`, by default the input (reference
    evaluate.py:27-32)."""
    buf = ctypes.create_string_buffer(4 * len(smiles.encode()) + 64)
    rc = get_lib().cchem_canonical_smiles(smiles.encode(), buf, len(buf))
    if rc != 0:
        return smiles if fallback is None else fallback
    return buf.value.decode()
