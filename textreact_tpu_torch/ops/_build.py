"""Build and load the hand-written CUDA kernels in `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use with nvcc for Hopper (`sm_90a`) into a shared library under
`textreact_tpu_torch/_kernel_build/`, then loaded with ctypes. A library is
rebuilt when its source or a shared header (`csrc/*.cuh`) is newer.
`build_all` compiles several sources at once, one nvcc process each. Every
entry point takes its pointers and the CUDA stream as `void*`, and returns
`cudaGetLastError()` after the launch, which `check` turns into an
exception.

No PyTorch header is compiled in, so a kernel builds in seconds rather
than minutes (`torch.utils.cpp_extension.load` is the slow alternative).

`build_host` compiles the C++ host accelerators (the WordPiece tokenizer,
the chemistry kernel) with g++ into the same directory, under a file lock,
so that processes that reach it at once build it once. A failed build
raises with the compiler's output: nothing falls back to Python on its own.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Optional

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


def _paths(name: str):
    return CSRC_DIR / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(src: Path, out: Path) -> bool:
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime for p in (src, *CSRC_DIR.glob("*.cuh")))
    return out.stat().st_mtime < newest


def _compile_one(nvcc: str, name: str) -> str:
    """Compile one source; returns "" or the failure's text."""
    src, out = _paths(name)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        return f"nvcc failed for {src.name}:\n{proc.stderr}"
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOG[name] = proc.stderr
    return ""


def _compile(names: Iterable[str]) -> None:
    """One nvcc process per source, all started together."""
    names = list(names)
    if not names:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        failures = [f for f in pool.map(lambda n: _compile_one(nvcc, n), names)
                    if f]
    if failures:
        raise RuntimeError("\n".join(failures))


def build_all(names: Iterable[str]) -> None:
    """Compile every stale library among `names` in parallel; `load` then
    finds them built."""
    with _lock:
        _compile([n for n in names if _stale(*_paths(n))])


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, compiled if missing or stale.

    `signatures` maps each entry point to its ctypes argtypes; every entry
    point returns an int error code."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src, out = _paths(name)
        if _stale(src, out):
            _compile([name])
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


def ptr(t: Optional[torch.Tensor]) -> Optional[ctypes.c_void_p]:
    """Device pointer of `t`, or a null pointer for None."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def dropout_threshold(p: float) -> int:
    """Keep iff bits >= threshold (the JAX kernels' rule)."""
    return min(int(p * (1 << 32)), (1 << 32) - 1)


def dropout_args(seed: Optional[torch.Tensor], p: float):
    """(seed pointer, threshold, 1 / (1 - p)) as the C entry points take
    them; a null seed means no dropout."""
    if seed is None:
        return None, 0, 1.0
    return ptr(seed), dropout_threshold(p), 1.0 / (1.0 - p)


def draw_seed(generator: Optional[torch.Generator],
              device: torch.device) -> torch.Tensor:
    """One 64-bit dropout seed as a (1,) int64 tensor on `device`, drawn from
    `generator` there: it never visits the host, so drawing it does not wait
    for the device."""
    return torch.randint(0, 1 << 62, (1,), generator=generator, device=device,
                         dtype=torch.int64)


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


HOST_FLAGS = ["-O2", "-std=c++20", "-shared", "-fPIC"]


def build_host(src: Path, name: str, build_dir: Path = BUILD_DIR) -> Path:
    """Path of `lib<name>.so` compiled from the C++ source `src` with g++,
    rebuilt when missing or older than `src`. Builds under an exclusive
    lock on `lib<name>.lock` to a temporary name, then renames, so a
    process that loaded an older copy keeps it and none reads a partial
    file. Raises RuntimeError with g++'s output when the build fails."""
    build_dir.mkdir(parents=True, exist_ok=True)
    out = build_dir / f"lib{name}.so"
    with open(build_dir / f"lib{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (out.exists() and src.exists()
                and out.stat().st_mtime >= src.stat().st_mtime):
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *HOST_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {src}:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


# dtype codes shared with the C entry points
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
