"""OpenPose skeleton renderer, body only (counterpart of the body part of
``pcdms_tpu/pose/skeleton.py``), drawn by ``pose/raster.py`` without cv2.

The drawing convention the stage-2 conditioning was trained on
(controlnet_aux's dwpose ``util.py``): limb ellipses of half-width 4 at 0.6
brightness, joint circles of radius 4 at full brightness, the 18-colour
wheel.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from pcdms_tpu_torch.pose.raster import (
    ellipse2poly, fill_circle, fill_convex_poly,
)

EPS = 0.01
STICKWIDTH = 4

# limb pairs in 1-based OpenPose indexing (as in the original CMU code)
LIMB_SEQ = [
    [2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
    [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
    [1, 16], [16, 18], [3, 17], [6, 18],
]

COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85],
]


def draw_bodypose(canvas: np.ndarray, keypoints: np.ndarray,
                  visible: Optional[np.ndarray] = None) -> np.ndarray:
    """Draw OpenPose-18 skeletons.

    canvas: (H, W, 3) uint8; the limbs are drawn into it and the dimmed
    copy with the joints is returned.
    keypoints: (N, 18, 2) or (18, 2) normalised [0, 1] (x, y).
    visible: (N, 18) mask; by default the joints with both coordinates
    above 0.01. A limb is drawn when both of its joints are visible.
    """
    h, w, _ = canvas.shape
    keypoints = np.asarray(keypoints, np.float32)
    if keypoints.ndim == 2:
        keypoints = keypoints[None]
    n = keypoints.shape[0]
    if visible is None:
        visible = (keypoints > EPS).all(axis=-1)
    visible = np.asarray(visible).astype(bool)

    # limbs: the first 17 pairs only, as in the reference
    for i in range(17):
        a, b = LIMB_SEQ[i][0] - 1, LIMB_SEQ[i][1] - 1
        for p in range(n):
            if not (visible[p, a] and visible[p, b]):
                continue
            y = keypoints[p, [a, b], 0] * w
            x = keypoints[p, [a, b], 1] * h
            m_x, m_y = x.mean(), y.mean()
            length = float(np.hypot(x[0] - x[1], y[0] - y[1]))
            angle = math.degrees(math.atan2(x[0] - x[1], y[0] - y[1]))
            poly = ellipse2poly((int(m_y), int(m_x)),
                                (int(length / 2), STICKWIDTH), int(angle))
            fill_convex_poly(canvas, poly, COLORS[i])

    canvas = (canvas * 0.6).astype(np.uint8)

    for i in range(18):
        for p in range(n):
            if not visible[p, i]:
                continue
            px = int(keypoints[p, i, 0] * w)
            py = int(keypoints[p, i, 1] * h)
            fill_circle(canvas, (px, py), 4, COLORS[i])
    return canvas


def render_pose(keypoints: np.ndarray, height: int, width: int,
                visible: Optional[np.ndarray] = None,
                draw_body: bool = True) -> np.ndarray:
    """A skeleton image: keypoints (N, 18, 2) or (18, 2) normalised ->
    (height, width, 3) uint8 RGB on black."""
    canvas = np.zeros((height, width, 3), np.uint8)
    if draw_body:
        canvas = draw_bodypose(canvas, keypoints, visible)
    return canvas
