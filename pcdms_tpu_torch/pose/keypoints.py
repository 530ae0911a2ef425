"""Pose keypoint handling on the host (the port's own copy of
``pcdms_tpu/pose/keypoints.py``, numpy only).

The stage-1 prior consumes 18 OpenPose body joints as 36 normalised floats
read from per-image ``.txt`` files. The DWPose extractor produces COCO-17
keypoints, which are remapped to the OpenPose-18 layout with a synthesised
neck joint.
"""

from __future__ import annotations

import numpy as np

# OpenPose-18 joint order
OPENPOSE_JOINTS = [
    "nose", "neck", "r_shoulder", "r_elbow", "r_wrist",
    "l_shoulder", "l_elbow", "l_wrist", "r_hip", "r_knee", "r_ankle",
    "l_hip", "l_knee", "l_ankle", "r_eye", "l_eye", "r_ear", "l_ear",
]

# In-place permutation on [coco-17 + neck@17]: openpose slot <- source
# index. Slots 0 (nose), 5 (l_shoulder) and 11 (l_hip) already hold the
# right joints and are untouched.
_MMPOSE_IDX = [17, 6, 8, 10, 7, 9, 12, 14, 16, 13, 15, 2, 1, 4, 3]
_OPENPOSE_IDX = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12, 13, 14, 15, 16, 17]


def read_pose_txt(path: str) -> np.ndarray:
    """Read 18 'x y' lines -> (36,) float32 [x0, y0, x1, y1, ...]."""
    coords = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            x, y = line.split()
            coords.extend([float(x), float(y)])
    return np.asarray(coords, np.float32)


def write_pose_txt(path: str, coords: np.ndarray) -> None:
    coords = np.asarray(coords).reshape(-1, 2)
    with open(path, "w") as f:
        for x, y in coords:
            f.write(f"{x} {y}\n")


def coco_to_openpose(keypoints: np.ndarray, scores: np.ndarray,
                     score_thresh: float = 0.3):
    """COCO-17 keypoints -> OpenPose-18 with a synthesised neck.

    keypoints: (N, 17, 2) normalised or pixel coords; scores: (N, 17).
    Returns (kpts18 (N, 18, 2), scores18 (N, 18)). The neck is the mean of
    the two shoulders; its score is 1 when both shoulder scores exceed the
    threshold, else 0.
    """
    keypoints = np.asarray(keypoints, np.float32)
    scores = np.asarray(scores, np.float32)

    neck = keypoints[:, [5, 6]].mean(axis=1, keepdims=True)    # (N,1,2)
    neck_score = ((scores[:, 5] > score_thresh)
                  & (scores[:, 6] > score_thresh)).astype(np.float32)

    out_k = np.concatenate([keypoints, neck], axis=1)          # (N,18,2)
    out_s = np.concatenate([scores, neck_score[:, None]], axis=1)

    out_k[:, _OPENPOSE_IDX] = out_k[:, _MMPOSE_IDX]
    out_s[:, _OPENPOSE_IDX] = out_s[:, _MMPOSE_IDX]
    return out_k, out_s


def flatten_keypoints(kpts18: np.ndarray) -> np.ndarray:
    """(18, 2) -> (36,) [x, y interleaved] for the stage-1 pose MLPs."""
    return np.asarray(kpts18, np.float32).reshape(-1)
