"""The DeepFashion pair list (the port's own copy of ``PairList`` from
``pcdms_tpu/data/datasets.py``): a JSON list of {"source_image": ...,
"target_image": ...} records and the reference's directory layout."""

from __future__ import annotations

import json
import os
from typing import Dict, List


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
