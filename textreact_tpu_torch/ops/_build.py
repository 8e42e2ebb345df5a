"""Build and load the hand-written CUDA kernels in `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use with nvcc for Hopper (`sm_90a`) into a shared library under
`textreact_tpu_torch/_kernel_build/`, then loaded with ctypes. A library is
rebuilt when its source is newer. Every entry point takes its pointers and
the CUDA stream as `void*`, and returns `cudaGetLastError()` after the
launch, which `check` turns into an exception.

No PyTorch header is compiled in, so a kernel builds in seconds rather
than minutes (`torch.utils.cpp_extension.load` is the slow alternative).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_kernel_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / shared-memory / spill report) per kernel
BUILD_LOG: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _compile(name: str, src: Path, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOG[name] = proc.stderr


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, compiled if missing or stale.

    `signatures` maps each entry point to its ctypes argtypes; every entry
    point returns an int error code."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC_DIR / f"{name}.cu"
        out = BUILD_DIR / f"lib{name}.so"
        if not out.exists() or out.stat().st_mtime < src.stat().st_mtime:
            _compile(name, src, out)
        lib = ctypes.CDLL(str(out))
        lib.tr_error_string.restype = ctypes.c_char_p
        lib.tr_error_string.argtypes = [ctypes.c_int]
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.tr_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


# dtype codes shared with the C entry points
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
