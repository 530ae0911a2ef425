"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` (``flash_attention.cu``: the forward kernels;
``flash_attention_bwd.cu``: the backward kernels; ``fused_conv.cu``: the
fused GroupNorm + SiLU + conv3x3 kernel) is compiled by ``nvcc``
for ``sm_90a`` into a shared library of its own with a plain C interface
and loaded with ``ctypes``. The builds run at first use, all ``nvcc``
processes started together, from the repository's sources only, into
``build/`` at the repository root; a library's file name carries a hash of
its source and of the shared headers, so an edited source is rebuilt and a
stale one never loads. Nothing here runs at import time. One lock
serialises building and loading, so threads that launch kernels at once (a
server's engine threads) wait for one build; each writer's temporary file
is named for its process and thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# held by build() and library() around building and loading
_LOCK = threading.Lock()
_LOADED = {}      # source stem -> its loaded library

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# source stem -> {C entry -> argtypes}; every entry returns
# cudaGetLastError() as an int
_ENTRIES = {
    "flash_attention": {
        "pcdms_flash_frozen": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
        "pcdms_flash_online": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
        "pcdms_flash_shortkv": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I,
                                _P],
        "pcdms_flash_fwd_lse": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    },
    "flash_attention_bwd": {
        "pcdms_flash_dq": [_P] * 7 + [_I, _I, _I, _F, _F, _I, _P],
        "pcdms_flash_dkv": [_P] * 8 + [_I, _I, _I, _F, _F, _I, _P],
    },
    "fused_conv": {
        "pcdms_fused_gn_silu_conv": [_P] * 8 + [_I] * 9 + [_P],
    },
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _library_path(stem: str) -> Path:
    digest = hashlib.sha256((_CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every library that is not there, all at once. Returns
    {source stem: seconds its nvcc took (0.0 if cached)}. The compiler's
    report (registers, shared memory, spills per kernel) is kept beside
    each library as ``.log``."""
    with _LOCK:
        return _build_all()


def _build_all() -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    start = time.perf_counter()
    for stem in _ENTRIES:
        lib = _library_path(stem)
        seconds[stem] = 0.0
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        procs[stem] = (lib, tmp, subprocess.Popen(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas=-v", "-o", str(tmp), str(_CSRC / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for stem, (lib, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[stem] = time.perf_counter() - start
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {stem}.cu:\n{out}")
        else:
            os.replace(tmp, lib)   # atomic: a concurrent loader sees all
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def library(stem: str) -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<stem>.cu``, built (with
    the others) on first use. A loaded library is returned without the
    lock; only a miss takes it."""
    lib = _LOADED.get(stem)
    if lib is not None:
        return lib
    with _LOCK:
        if stem in _LOADED:
            return _LOADED[stem]
        if not _library_path(stem).exists():
            _build_all()
        lib = ctypes.CDLL(str(_library_path(stem)))
        for entry, argtypes in _ENTRIES[stem].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LOADED[stem] = lib
        return lib


def build_log(stem: str) -> str:
    path = _library_path(stem).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def check(status: int, entry: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if status != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with error {status}")
