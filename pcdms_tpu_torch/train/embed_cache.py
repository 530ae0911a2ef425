"""Disk cache of frozen-encoder outputs for training (counterpart of
``pcdms_tpu/train/embed_cache.py``, the same files).

The reference re-encodes the conditioning images with the frozen CLIP /
DINOv2 towers at every step. Condition dropout zeroes the pixel inputs
(``data/datasets.py``), so the null condition is exactly the encoder's
output on a zero image: each image needs its own row, and all of them
share one zero-input row. One encoder pass per unique image replaces one
per (step x example), and the training data path skips the image decode.

Layout: ``<root>/<name>/data.npy``, an (N + 1, ...) array opened with mmap
(row 0: the encoder's output on a zero input, not zeros), and
``<root>/<name>/index.json`` mapping image path -> row. A cache written by
either package reads in the other.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Sequence

import numpy as np

logger = logging.getLogger("pcdms_tpu_torch.embed_cache")


class EmbeddingCache:
    def __init__(self, root: str, name: str):
        self.dir = os.path.join(root, name)
        self._data = None
        self._index = None

    @property
    def data_path(self):
        return os.path.join(self.dir, "data.npy")

    @property
    def index_path(self):
        return os.path.join(self.dir, "index.json")

    def exists(self) -> bool:
        return os.path.exists(self.data_path) and \
            os.path.exists(self.index_path)

    def _load(self):
        if self._data is None:
            self._data = np.load(self.data_path, mmap_mode="r")
            with open(self.index_path) as f:
                self._index = json.load(f)
        return self._data, self._index

    def build(self, encode_fn: Callable, preprocess_fn: Callable,
              paths: Sequence[str], batch_size: int = 32,
              store_dtype=np.float32, log_every: int = 20) -> None:
        """Encode every unique path once.

        encode_fn: (B, ...) numpy pixel batch -> (B, ...) embeddings (numpy
            or a tensor on any device; read back to the host here).
        preprocess_fn: path -> pixel array, the train-time transform
            (resize included), so that a cached row is what the data path
            would have encoded.
        """
        paths = list(dict.fromkeys(paths))        # unique, order kept
        os.makedirs(self.dir, exist_ok=True)

        zero_px = np.zeros_like(preprocess_fn(paths[0]))
        zero_embed = _host(encode_fn(zero_px[None]))[0]

        out = np.lib.format.open_memmap(
            self.data_path, mode="w+", dtype=store_dtype,
            shape=(len(paths) + 1,) + zero_embed.shape)
        out[0] = zero_embed.astype(store_dtype)
        for start in range(0, len(paths), batch_size):
            chunk = paths[start:start + batch_size]
            px = np.stack([preprocess_fn(p) for p in chunk])
            out[1 + start:1 + start + len(chunk)] = \
                _host(encode_fn(px)).astype(store_dtype)
            if (start // batch_size) % log_every == 0:
                logger.info("embed cache %s: %d/%d", self.dir,
                            start + len(chunk), len(paths))
        out.flush()
        del out

        with open(self.index_path, "w") as f:
            json.dump({p: i + 1 for i, p in enumerate(paths)}, f)
        self._data = self._index = None
        logger.info("embed cache %s: built %d entries (+zero row), %s",
                    self.dir, len(paths), np.dtype(store_dtype).name)

    def lookup(self, refs: Sequence[str], dropped=None) -> np.ndarray:
        """refs: image paths; dropped: optional bool / float mask, a dropped
        item reads the zero-input row 0. Returns f32."""
        data, index = self._load()
        rows = np.asarray([index[str(r)] for r in refs], np.int64)
        if dropped is not None:
            rows = np.where(np.asarray(dropped).astype(bool), 0, rows)
        return np.asarray(data[rows], np.float32)


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


def build_or_load(root: str, name: str, encode_fn, preprocess_fn, paths,
                  batch_size: int = 32,
                  store_dtype=np.float32) -> EmbeddingCache:
    cache = EmbeddingCache(root, name)
    if not cache.exists():
        cache.build(encode_fn, preprocess_fn, paths,
                    batch_size=batch_size, store_dtype=store_dtype)
    else:
        logger.info("embed cache %s: reusing existing", cache.dir)
    return cache
