"""The DeepFashion pair list (the port's own copy of ``PairList`` from
``pcdms_tpu/data/datasets.py``): a JSON list of {"source_image": ...,
"target_image": ...} records and the reference's directory layout; and
the stage-3 dataset's paths to the stage-2 outputs."""

from __future__ import annotations

import json
import os
from typing import Dict, List


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


class Stage3Dataset:
    """The stage-3 pairs with their stage-2 images
    (``{gen_dir}/{src}_to_{tgt}.png``). The batch test uses ``gen_path``;
    the training examples wait for the stage-3 trainer (ROADMAP item
    19b)."""

    def __init__(self, pairs: PairList, gen_dir: str, size=(512, 512),
                 gen_drop_rate=0.0, seed=0, embed_refs: bool = False):
        self.pairs = pairs
        self.gen_dir = gen_dir
        self.size = size
        self.gen_drop_rate = gen_drop_rate
        self.seed = seed
        self.embed_refs = embed_refs

    def __len__(self):
        return len(self.pairs)

    def gen_path(self, item) -> str:
        return os.path.join(self.gen_dir, f"{pair_stem(item)}.png")

    def _example(self, idx, rng):
        raise NotImplementedError("stage-3 training examples are not ported "
                                  "yet (ROADMAP item 19b)")
