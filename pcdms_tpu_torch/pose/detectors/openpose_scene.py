"""A crafted OpenPose scene, built in numpy: the body network's outputs (19
heat and 38 part-affinity channels) for one or two standing people, and
smooth bumps in the hand and face networks' output layouts.

A body network with random weights finds only spurious peaks and assembles
nobody, so the PAF assembly, the hand and face crops and their networks
never run. The detector's checks put these maps in place of the body
network's output (``OpenposeDetector._forward``) to drive that whole path.
"""

from __future__ import annotations

import math

import numpy as np

from pcdms_tpu_torch.pose.detectors.openpose_decode import _LIMBS, _PAF_IDX

# 18 joints of a standing person in OpenPose order, as (x, y) in a unit box
SKELETON = np.array([
    [48, 12], [48, 24], [38, 24], [34, 40], [32, 56], [58, 24], [62, 40],
    [64, 56], [42, 52], [40, 70], [40, 86], [54, 52], [56, 70], [56, 86],
    [44, 8], [52, 8], [40, 10], [56, 10]], np.float64) / 96.0


def bump(h, w, cy, cx, sigma=2.0) -> np.ndarray:
    """An (h, w) f64 Gaussian of peak 1 at (cy, cx)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    return np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma ** 2))


def scene(h, w, sigma=2.0, n=2):
    """``n`` (1 or 2) people (``SKELETON`` scaled into (h, w), the second
    shifted right) -> (heat (h, w, 19), paf (h, w, 38)), f32."""
    people = [SKELETON * [w * 0.45, h * 0.9] + [w * 0.02, 0.21],
              SKELETON * [w * 0.45, h * 0.9] + [w * 0.5, 0.21]][:n]
    heat = np.zeros((h, w, 19))
    paf = np.zeros((h, w, 38))
    for kpts in people:
        for j, (x, y) in enumerate(kpts):
            heat[:, :, j] += bump(h, w, y, x, sigma)
        for (ja, jb), (ca, cb) in zip(_LIMBS, _PAF_IDX):
            vec = kpts[jb] - kpts[ja]
            norm = math.hypot(*vec)
            for s in np.linspace(0, 1, max(2, int(2 * norm))):
                px, py = kpts[ja] + s * vec
                yy, xx = int(round(py)), int(round(px))
                paf[max(yy - 1, 0):yy + 2, max(xx - 1, 0):xx + 2, ca] = \
                    vec[0] / norm
                paf[max(yy - 1, 0):yy + 2, max(xx - 1, 0):xx + 2, cb] = \
                    vec[1] / norm
    return heat.astype(np.float32), paf.astype(np.float32)


def network_outputs(h, w, people=2):
    """The networks' outputs for an (h, w) input, each (1, h/8, w/8, C)
    f32 NHWC: the body's PAF and heat of the scene, the hand's 22 and the
    face's 71 bumps."""
    gh, gw = h // 8, w // 8
    heat, paf = scene(gh, gw, sigma=1.0, n=people)
    hand = np.stack([bump(gh, gw, gh * (0.2 + 0.03 * i), gw * (0.3 + 0.02 * i),
                          1.0) for i in range(22)], -1).astype(np.float32)
    face = np.stack([bump(gh, gw, gh * (0.1 + 0.01 * i), gw * 0.5, 1.0)
                     for i in range(71)], -1).astype(np.float32)
    return paf[None], heat[None], hand[None], face[None]
