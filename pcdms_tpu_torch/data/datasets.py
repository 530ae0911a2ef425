"""DeepFashion pair datasets on the host (the port's own copy of
``pcdms_tpu/data/datasets.py``, numpy / PIL only): numpy NHWC examples for
the three trainers.

  * ``Stage1Dataset``: CLIP-preprocessed source and target images and the
    36-float pose vectors, each with its own condition dropout, which
    zeroes the pixel or coordinate inputs (so the null condition of
    classifier-free guidance is the zero-image embedding);
  * ``Stage2Dataset``: the [source | black] masked canvas, the
    [source | target] canvas, the [source pose | target pose] skeleton
    canvas, and the CLIP-preprocessed source (DINOv2 branch) and target
    (CLIP branch), each with its own dropout;
  * ``Stage3Dataset``: the target, the stage-2 image of the pair
    (``{gen_dir}/{src}_to_{tgt}.png``) with dropout, and the
    CLIP-preprocessed source.

The pair list is a JSON list of {"source_image": ..., "target_image": ...}
records in the reference's directory layout. ``embed_refs=True`` yields the
encoder inputs as image paths and dropout flags instead of pixels, for the
embedding cache (``train/embed_cache.py``); the random draws are the same in
both modes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from pcdms_tpu_torch.data.preprocess import (
    black_like, clip_preprocess, load_image, make_side_by_side, to_neg1_1,
)
from pcdms_tpu_torch.pose.keypoints import read_pose_txt


def pair_stem(item) -> str:
    """``{src}_to_{tgt}``: the file stem of a pair's outputs (the stage-1
    ``.npy``, the stage-2 and stage-3 PNGs)."""
    s = os.path.basename(item["source_image"]).rsplit(".", 1)[0]
    t = os.path.basename(item["target_image"]).rsplit(".", 1)[0]
    return f"{s}_to_{t}"


class PairList:
    """The DeepFashion (source, target) pair list."""

    def __init__(self, json_path_or_list, image_root: str = ""):
        if isinstance(json_path_or_list, str):
            with open(json_path_or_list) as f:
                self.pairs: List[Dict] = json.load(f)
        else:
            self.pairs = list(json_path_or_list)
        self.image_root = image_root

    def __len__(self):
        return len(self.pairs)

    def image_path(self, name: str) -> str:
        return os.path.join(self.image_root, name.replace(".jpg", ".png"))

    def pose_txt_path(self, name: str) -> str:
        # reference layout: /train_all_png/ -> /normalized_pose_txt/
        return os.path.join(self.image_root, name).replace(
            "/train_all_png/", "/normalized_pose_txt/").replace(
            ".jpg", ".txt")

    def pose_img_path(self, name: str) -> str:
        # reference layout: /train_all_png/ -> /openpose_all_img/*_pose.jpg
        return os.path.join(self.image_root,
                            name.replace(".jpg", ".png")).replace(
            "/train_all_png/", "/openpose_all_img/").replace(
            ".png", "_pose.jpg")

    def shard(self, process_index: int, process_count: int) -> "PairList":
        """Every ``process_count``-th pair from ``process_index``."""
        return PairList(self.pairs[process_index::process_count],
                        self.image_root)


class _StatelessDropout:
    """Two ways to draw an example's dropout.

    ``__getitem__`` draws from the dataset's own stream (``self.rng``), in
    the order examples are fetched, as the reference's torch datasets do.
    ``fetch(idx, epoch)`` draws from a generator keyed by
    ``(seed, epoch, idx)``, so a pool of workers yields the same batches
    for any worker count (``data/loader.py``).
    """

    def fetch(self, idx: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        return self._example(int(idx), rng)

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        return self._example(int(idx), self.rng)

    def __len__(self):
        return len(self.pairs)


class Stage1Dataset(_StatelessDropout):
    def __init__(self, pairs: PairList, size=(512, 512),
                 s_img_drop_rate=0.0, t_img_drop_rate=0.0,
                 s_pose_drop_rate=0.0, t_pose_drop_rate=0.0, seed=0,
                 embed_refs: bool = False):
        self.pairs = pairs
        self.size = size
        self.drop = (s_img_drop_rate, t_img_drop_rate,
                     s_pose_drop_rate, t_pose_drop_rate)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.embed_refs = embed_refs

    def _example(self, idx, rng) -> Dict[str, np.ndarray]:
        item = self.pairs.pairs[idx]
        s_pose = read_pose_txt(self.pairs.pose_txt_path(item["source_image"]))
        t_pose = read_pose_txt(self.pairs.pose_txt_path(item["target_image"]))

        dr = self.drop
        s_drop = rng.random() < dr[0]
        t_drop = rng.random() < dr[1]
        if rng.random() < dr[2]:
            s_pose = np.zeros_like(s_pose)
        if rng.random() < dr[3]:
            t_pose = np.zeros_like(t_pose)

        if self.embed_refs:
            return {"s_ref": self.pairs.image_path(item["source_image"]),
                    "t_ref": self.pairs.image_path(item["target_image"]),
                    "s_drop": np.float32(s_drop),
                    "t_drop": np.float32(t_drop),
                    "s_pose": s_pose, "t_pose": t_pose}

        clip_s = clip_preprocess(load_image(
            self.pairs.image_path(item["source_image"]), self.size))
        clip_t = clip_preprocess(load_image(
            self.pairs.image_path(item["target_image"]), self.size))
        if s_drop:
            clip_s = np.zeros_like(clip_s)
        if t_drop:
            clip_t = np.zeros_like(clip_t)
        return {"clip_s_img": clip_s, "clip_t_img": clip_t,
                "s_pose": s_pose, "t_pose": t_pose}


class Stage2Dataset(_StatelessDropout):
    def __init__(self, pairs: PairList, size=(512, 512),
                 imgp_drop_rate=0.0, imgg_drop_rate=0.0, seed=0,
                 embed_refs: bool = False):
        self.pairs = pairs
        self.size = size
        self.imgp_drop_rate = imgp_drop_rate
        self.imgg_drop_rate = imgg_drop_rate
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.embed_refs = embed_refs

    def _example(self, idx, rng) -> Dict[str, np.ndarray]:
        item = self.pairs.pairs[idx]
        s_img = load_image(self.pairs.image_path(item["source_image"]),
                           self.size)
        t_img = load_image(self.pairs.image_path(item["target_image"]),
                           self.size)
        s_pose = load_image(self.pairs.pose_img_path(item["source_image"]),
                            self.size)
        t_pose = load_image(self.pairs.pose_img_path(item["target_image"]),
                            self.size)
        out = {
            "st_image": to_neg1_1(make_side_by_side(s_img, t_img)),
            "masked_image": to_neg1_1(make_side_by_side(s_img,
                                                        black_like(s_img))),
            "pose_image": to_neg1_1(make_side_by_side(s_pose, t_pose)),
        }

        s_drop = rng.random() < self.imgp_drop_rate
        t_drop = rng.random() < self.imgg_drop_rate
        if self.embed_refs:
            out.update({
                "s_ref": self.pairs.image_path(item["source_image"]),
                "t_ref": self.pairs.image_path(item["target_image"]),
                "s_drop": np.float32(s_drop),
                "t_drop": np.float32(t_drop),
            })
            return out

        clip_s = clip_preprocess(s_img)   # DINOv2 branch
        clip_t = clip_preprocess(t_img)   # CLIP branch
        if s_drop:
            clip_s = np.zeros_like(clip_s)
        if t_drop:
            clip_t = np.zeros_like(clip_t)
        out.update({"clip_s_img": clip_s, "clip_t_img": clip_t})
        return out


class Stage3Dataset(_StatelessDropout):
    """The stage-3 pairs with their stage-2 images
    (``{gen_dir}/{src}_to_{tgt}.png``). The batch test uses ``gen_path``
    only."""

    def __init__(self, pairs: PairList, gen_dir: str, size=(512, 512),
                 gen_drop_rate=0.0, seed=0, embed_refs: bool = False):
        self.pairs = pairs
        self.gen_dir = gen_dir
        self.size = size
        self.gen_drop_rate = gen_drop_rate
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.embed_refs = embed_refs

    def gen_path(self, item) -> str:
        return os.path.join(self.gen_dir, f"{pair_stem(item)}.png")

    def _example(self, idx, rng) -> Dict[str, np.ndarray]:
        item = self.pairs.pairs[idx]
        s_img = load_image(self.pairs.image_path(item["source_image"]),
                           self.size)
        t_img = load_image(self.pairs.image_path(item["target_image"]),
                           self.size)
        gen = to_neg1_1(load_image(self.gen_path(item), self.size))
        if rng.random() < self.gen_drop_rate:
            gen = np.zeros_like(gen)

        out = {"target_image": to_neg1_1(t_img), "gen_image": gen}
        if self.embed_refs:
            out["s_ref"] = self.pairs.image_path(item["source_image"])
        else:
            out["clip_s_img"] = clip_preprocess(s_img)
        return out


def stack_examples(examples) -> Dict[str, np.ndarray]:
    """A list of example dicts -> one dict of stacked arrays."""
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}


def index_batches(n: int, batch_size: int, *, shuffle: bool, seed: int,
                  drop_last: bool, epochs: Optional[int]
                  ) -> Iterator[Tuple[int, np.ndarray]]:
    """(epoch, index array) per batch of ``n`` examples: one
    ``default_rng(seed)`` permutation per epoch, the shuffle stream of
    ``batch_iterator`` and ``data/loader.py::DataLoader``. ``epochs=None``
    loops forever."""
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if shuffle else np.arange(n)
        end = n - (n % batch_size) if drop_last else n
        for start in range(0, end, batch_size):
            yield epoch, order[start:start + batch_size]
        epoch += 1


def batch_iterator(dataset, batch_size: int, *, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True,
                   epochs: Optional[int] = None) -> Iterator[Dict]:
    """Stacked numpy batches through ``dataset[i]`` (its own dropout
    stream), in the order of ``index_batches``."""
    n = len(dataset)
    if drop_last and n < batch_size:
        raise ValueError(
            f"dataset has {n} examples < batch_size {batch_size} with "
            "drop_last=True: no batch can ever be formed (with "
            "epochs=None this would spin forever)")
    for _, idxs in index_batches(n, batch_size, shuffle=shuffle, seed=seed,
                                 drop_last=drop_last, epochs=epochs):
        yield stack_examples([dataset[int(i)] for i in idxs])
