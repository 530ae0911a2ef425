"""Build and load the port's CUDA kernels.

``csrc/flash_attention.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build runs at first use, from the repository's sources only, into
``build/`` at the repository root; the library's file name carries a hash
of its source, so an edited source is rebuilt and a stale one never loads.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argtypes; every entry returns cudaGetLastError() as an int
_ENTRIES = {
    "pcdms_flash_frozen": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "pcdms_flash_online": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    "pcdms_flash_shortkv": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{_SOURCE.stem}_{digest[:16]}.so"


def build() -> float:
    """Compile the library unless it is there. Returns the seconds the build
    took (0.0 if it was cached). The compiler's report (registers, shared
    memory, spills per kernel) is kept beside the library as ``.log``."""
    lib = _library_path()
    if lib.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    start = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
         "-o", str(tmp), str(_SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - start
    lib.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {_SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none
    return seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    build()
    lib = ctypes.CDLL(str(_library_path()))
    for entry, argtypes in _ENTRIES.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_log() -> str:
    path = _library_path().with_suffix(".log")
    return path.read_text() if path.exists() else ""


def check(status: int, entry: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if status != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with error {status}")
