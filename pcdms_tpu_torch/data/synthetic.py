"""Synthetic pose-transfer world ("stick people"), the port's copy of
``pcdms_tpu/data/synthetic.py``, drawn by ``pose/raster.py`` without cv2.

A deterministic miniature of the DeepFashion pose-transfer task in the
disk layout the data layer reads (``train_all_png/``,
``normalized_pose_txt/``, ``openpose_all_img/*_pose.jpg`` and the
``{"source_image", "target_image"}`` pair JSONs), on which the learning
proof (``cli/learning_proof.py``) trains the tiny configurations through
the real CLIs.

* An identity is a colour palette (limb colours, head colour, background
  tint) drawn from the identity index.
* A pose is an 18-joint OpenPose skeleton: a canonical standing figure
  with per-pose arm swing, leg step and sway, every joint in frame.
* The person image paints the skeleton with the identity's colours (thick
  limbs, a filled head) on its background, so pose transfer is exactly
  "repaint the target skeleton with the source image's palette".
* The conditioning is the system's own: pose ``.txt`` files through
  ``pose/keypoints.py::write_pose_txt`` and skeleton renders through
  ``pose/skeleton.py::draw_bodypose``.

Everything derives from ``np.random.default_rng(SeedSequence([seed,
identity, pose]))``: no global state, the same bytes on every run, and the
same as the JAX package's.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

from pcdms_tpu_torch.pose.keypoints import write_pose_txt
from pcdms_tpu_torch.pose.raster import (
    ellipse2poly, fill_circle, fill_convex_poly,
)
from pcdms_tpu_torch.pose.skeleton import LIMB_SEQ, draw_bodypose

# OpenPose-18 joint indices (pose/keypoints.py layout)
NOSE, NECK = 0, 1
RSHO, RELB, RWRI = 2, 3, 4
LSHO, LELB, LWRI = 5, 6, 7
RHIP, RKNE, RANK = 8, 9, 10
LHIP, LKNE, LANK = 11, 12, 13
REYE, LEYE, REAR, LEAR = 14, 15, 16, 17


def identity_palette(identity: int, seed: int = 0):
    """Deterministic appearance for one identity: 17 limb colors spun
    around the HSV wheel from an identity-specific hue, plus head and
    (dark) background colors. Hues are spaced so identities are easily
    separable for a conv net reading raw pixels."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, identity, 7]))
    base_hue = (identity * 0.37 + rng.uniform(0, 0.05)) % 1.0

    def hsv(h, s, v):
        h = (h % 1.0) * 6.0
        i = int(h)
        f = h - i
        p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
        rgb = [(v, t, p), (q, v, p), (p, v, t),
               (p, q, v), (t, p, v), (v, p, q)][i % 6]
        return tuple(int(255 * c) for c in rgb)

    limb_colors = [hsv(base_hue + 0.13 * (i % 4), 0.85, 0.95)
                   for i in range(17)]
    head_color = hsv(base_hue + 0.5, 0.7, 0.95)
    background = hsv(base_hue + 0.25, 0.35, 0.18)
    return {"limbs": limb_colors, "head": head_color, "bg": background}


def sample_pose(identity: int, pose_idx: int, seed: int = 0) -> np.ndarray:
    """(18, 2) normalized (x, y) joints for one (identity, pose). The
    skeleton is a canonical standing figure with per-pose arm/leg swing
    and global sway; joints stay in [0.08, 0.95]."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, identity, pose_idx]))
    cx = 0.5 + rng.uniform(-0.08, 0.08)
    cy = 0.30 + rng.uniform(-0.04, 0.04)
    lean = rng.uniform(-0.15, 0.15)            # torso lean (radians)

    k = np.zeros((18, 2), np.float32)
    k[NECK] = (cx, cy)
    k[NOSE] = (cx - 0.10 * np.sin(lean), cy - 0.10 * np.cos(lean))
    k[REYE] = k[NOSE] + (-0.025, -0.02)
    k[LEYE] = k[NOSE] + (0.025, -0.02)
    k[REAR] = k[NOSE] + (-0.05, 0.0)
    k[LEAR] = k[NOSE] + (0.05, 0.0)

    k[RSHO] = (cx - 0.11, cy + 0.02)
    k[LSHO] = (cx + 0.11, cy + 0.02)

    def limb(origin, angle, length):
        return (origin[0] + length * np.sin(angle),
                origin[1] + length * np.cos(angle))

    # arms: angle measured from straight-down; swings per pose
    ra_u = rng.uniform(-1.5, 0.5)              # right upper-arm swing
    ra_l = ra_u + rng.uniform(-0.9, 0.9)       # elbow bend
    la_u = rng.uniform(-0.5, 1.5)
    la_l = la_u + rng.uniform(-0.9, 0.9)
    k[RELB] = limb(k[RSHO], ra_u - 0.15, 0.13)
    k[RWRI] = limb(k[RELB], ra_l - 0.15, 0.12)
    k[LELB] = limb(k[LSHO], la_u + 0.15, 0.13)
    k[LWRI] = limb(k[LELB], la_l + 0.15, 0.12)

    hip_y = cy + 0.27 + rng.uniform(-0.02, 0.02)
    k[RHIP] = (cx - 0.07 + 0.05 * np.sin(lean), hip_y)
    k[LHIP] = (cx + 0.07 + 0.05 * np.sin(lean), hip_y)

    rl_u = rng.uniform(-0.55, 0.35)            # leg step angles
    rl_l = rl_u + rng.uniform(-0.35, 0.35)
    ll_u = rng.uniform(-0.35, 0.55)
    ll_l = ll_u + rng.uniform(-0.35, 0.35)
    k[RKNE] = limb(k[RHIP], rl_u, 0.16)
    k[RANK] = limb(k[RKNE], rl_l, 0.15)
    k[LKNE] = limb(k[LHIP], ll_u, 0.16)
    k[LANK] = limb(k[LKNE], ll_l, 0.15)

    return np.clip(k, 0.08, 0.95)


def render_person(keypoints: np.ndarray, palette, size: int = 64,
                  stickwidth: int = 3) -> np.ndarray:
    """Rasterize the figure with identity colors -> (size, size, 3) u8.
    Same ellipse-limb technique as the skeleton rasterizer
    (pose/skeleton.py draw_bodypose) but palette-colored, head filled,
    and no 0.6 dimming — this is the *person image*, not the
    conditioning render."""
    h = w = size
    canvas = np.empty((h, w, 3), np.uint8)
    canvas[:] = palette["bg"]
    kp = np.asarray(keypoints, np.float32)

    for i in range(17):
        a, b = LIMB_SEQ[i][0] - 1, LIMB_SEQ[i][1] - 1
        xs = kp[[a, b], 0] * w
        ys = kp[[a, b], 1] * h
        mx, my = xs.mean(), ys.mean()
        length = float(np.hypot(xs[0] - xs[1], ys[0] - ys[1]))
        angle = float(np.degrees(np.arctan2(ys[0] - ys[1], xs[0] - xs[1])))
        poly = ellipse2poly((int(mx), int(my)),
                            (max(int(length / 2), 1), stickwidth), int(angle))
        fill_convex_poly(canvas, poly, palette["limbs"][i])

    nx, ny = int(kp[NOSE, 0] * w), int(kp[NOSE, 1] * h)
    fill_circle(canvas, (nx, ny), max(size // 14, 2), palette["head"])
    return canvas


def render_skeleton(keypoints: np.ndarray, size: int = 64) -> np.ndarray:
    """The conditioning render: standard OpenPose colors on black, via
    the production rasterizer."""
    canvas = np.zeros((size, size, 3), np.uint8)
    return draw_bodypose(canvas, keypoints[None])


def generate_dataset(root: str, n_identities: int = 6, n_poses: int = 8,
                     n_test_poses: int = 2, size: int = 64, seed: int = 0,
                     max_train_pairs_per_identity: int = 30,
                     ) -> Tuple[str, str]:
    """Write the synthetic world to ``root`` in the DeepFashion layout.

    Per identity, poses ``[0, n_poses - n_test_poses)`` are the train
    poses (all ordered train-pose pairs, capped) and the last
    ``n_test_poses`` are held-out *target* poses for the test pairs
    (source = a train pose, target = an unseen pose of the same
    identity — the model must generalize over pose, the DeepFashion
    test-set axis that matters for the conditioning path).

    Returns (train_pairs.json path, test_pairs.json path).
    """
    from PIL import Image

    img_dir = os.path.join(root, "train_all_png")
    txt_dir = os.path.join(root, "normalized_pose_txt")
    pose_dir = os.path.join(root, "openpose_all_img")
    for d in (img_dir, txt_dir, pose_dir):
        os.makedirs(d, exist_ok=True)

    def stem(i, p):
        return f"id{i}_p{p}"

    for i in range(n_identities):
        pal = identity_palette(i, seed)
        for p in range(n_poses):
            kp = sample_pose(i, p, seed)
            Image.fromarray(render_person(kp, pal, size)).save(
                os.path.join(img_dir, f"{stem(i, p)}.png"))
            Image.fromarray(render_skeleton(kp, size)).save(
                os.path.join(pose_dir, f"{stem(i, p)}_pose.jpg"),
                quality=95)
            write_pose_txt(os.path.join(txt_dir, f"{stem(i, p)}.txt"), kp)

    def pair(i, ps, pt):
        return {"source_image": f"train_all_png/{stem(i, ps)}.jpg",
                "target_image": f"train_all_png/{stem(i, pt)}.jpg"}

    n_train_poses = n_poses - n_test_poses
    train_pairs: List[dict] = []
    for i in range(n_identities):
        per_id = [(ps, pt) for ps in range(n_train_poses)
                  for pt in range(n_train_poses) if ps != pt]
        train_pairs.extend(pair(i, ps, pt)
                           for ps, pt in
                           per_id[:max_train_pairs_per_identity])

    test_pairs = [pair(i, ps, pt)
                  for i in range(n_identities)
                  for pt in range(n_train_poses, n_poses)
                  for ps in (0, 1)]

    train_json = os.path.join(root, "train_pairs.json")
    test_json = os.path.join(root, "test_pairs.json")
    with open(train_json, "w") as f:
        json.dump(train_pairs, f)
    with open(test_json, "w") as f:
        json.dump(test_pairs, f)
    return train_json, test_json
