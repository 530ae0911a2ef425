"""ctypes bindings of the native (C++ / OpenMP) host preprocessing library
``native/src/preprocess.cpp`` (the port's copy of
``pcdms_tpu/data/native.py``): bicubic resize, the [-1, 1] and CLIP
normalisations, side-by-side canvases and the OpenPose-18 body render.

The library is built with ``g++`` at first use into ``build/`` at the
repository root (git-ignored), under a file name that carries a hash of the
source, so an edited source is rebuilt and a stale library never loads;
nothing is written under ``native/``. One lock serialises building and
loading; each writer's temporary file is named for its process and thread
and moved into place atomically, so concurrent first uses (data-loader
threads, test workers) never load a half-written file. A failed build
raises: there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from pcdms_tpu_torch.data.preprocess import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from pcdms_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "src" / \
    "preprocess.cpp"
_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I = ctypes.c_int
_ARGTYPES = {
    "resize_bicubic_u8": [_U8P, _I, _I, _I, _U8P, _I, _I],
    "normalize_neg1_1": [_U8P, _F32P, ctypes.c_int64],
    "normalize_clip": [_U8P, _F32P, ctypes.c_int64, _F32P, _F32P],
    "compose_side_by_side": [_U8P, _U8P, _U8P, _I, _I, _I],
    "draw_bodypose_native": [_U8P, _I, _I, _F32P, _U8P, _I],
}


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libpcdms_preprocess_{digest}.so"


def _build(lib: Path) -> None:
    """g++ with the flags of ``native/Makefile`` into ``lib``."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [os.environ.get("CXX", "g++"), "-O3", "-march=native", "-fPIC",
         "-fopenmp", "-std=c++17", "-Wall", "-shared", "-o", str(tmp),
         str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, lib)


def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _LOCK:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _ARGTYPES.items():
                getattr(lib, name).argtypes = argtypes
            _lib = lib
    return _lib


def _u8(a):
    return a.ctypes.data_as(_U8P)


def _f32(a):
    return a.ctypes.data_as(_F32P)


def resize_bicubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C) uint8, cv2-INTER_CUBIC-style."""
    lib = library()
    img = np.ascontiguousarray(img, np.uint8)
    sh, sw, c = img.shape
    out = np.empty((height, width, c), np.uint8)
    lib.resize_bicubic_u8(_u8(img), sh, sw, c, _u8(out), height, width)
    return out


def to_neg1_1(img: np.ndarray) -> np.ndarray:
    """uint8 -> f32 in [-1, 1]."""
    lib = library()
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty(img.shape, np.float32)
    lib.normalize_neg1_1(_u8(img), _f32(out), img.size)
    return out


def clip_normalize(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> CLIP-normalised f32 (no resize or crop)."""
    lib = library()
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty(img.shape, np.float32)
    mean = np.ascontiguousarray(CLIP_IMAGE_MEAN, np.float32)
    std = np.ascontiguousarray(CLIP_IMAGE_STD, np.float32)
    lib.normalize_clip(_u8(img), _f32(out), img.shape[0] * img.shape[1],
                       _f32(mean), _f32(std))
    return out


def compose_side_by_side(left: np.ndarray,
                         right: Optional[np.ndarray]) -> np.ndarray:
    """[left | right] uint8 canvases; right=None -> black."""
    lib = library()
    left = np.ascontiguousarray(left, np.uint8)
    h, w, c = left.shape
    out = np.empty((h, 2 * w, c), np.uint8)
    rptr = (_u8(np.ascontiguousarray(right, np.uint8)) if right is not None
            else ctypes.cast(None, _U8P))
    lib.compose_side_by_side(_u8(left), rptr, _u8(out), h, w, c)
    return out


def render_pose(keypoints: np.ndarray, height: int, width: int,
                visible: Optional[np.ndarray] = None) -> np.ndarray:
    """OpenPose-18 body render: keypoints (N, 18, 2) or (18, 2)
    normalised -> (height, width, 3) uint8. ``visible`` (N, 18) counts any
    non-zero value as visible; by default the joints above 0.01."""
    lib = library()
    keypoints = np.ascontiguousarray(keypoints, np.float32)
    if keypoints.ndim == 2:
        keypoints = keypoints[None]
    if visible is None:
        visible = (keypoints > 0.01).all(axis=-1)
    # to bool before uint8: a float confidence of 0.9 must stay visible
    visible = np.ascontiguousarray(
        np.asarray(visible).astype(bool).astype(np.uint8))
    canvas = np.zeros((height, width, 3), np.uint8)
    lib.draw_bodypose_native(_u8(canvas), height, width, _f32(keypoints),
                             _u8(visible), keypoints.shape[0])
    return canvas
