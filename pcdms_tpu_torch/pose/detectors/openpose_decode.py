"""OpenPose host-side decoding: heatmap peaks -> PAF scoring -> people (the
port's own copy of ``pcdms_tpu/pose/detectors/openpose_decode.py``).

Semantics-preserving re-derivation of the CMU/pytorch-openpose decode the
reference vendors (controlnet_aux ``open_pose/body.py``:42-227,
``hand.py``:22-80, ``util.py``:202-378). All order-dependent greedy steps
(connection selection, subset growth/merge) follow the published algorithm
exactly: the output feeds the skeleton renderer the stage-2 conditioning
was trained on.

Everything here is numpy + scipy (gaussian blur, connected components);
the CNN forwards live in ``pcdms_tpu_torch.pose.detectors.openpose``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

# limb k connects OpenPose joints _LIMBS[k]; its PAF lives in channels
# _PAF_IDX[k] of the 38-ch L1 output (body.py:115-119, 1-based there)
_LIMBS = [(1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
          (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
          (0, 15), (15, 17), (2, 16), (5, 17)]
_PAF_IDX = [(12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25),
            (0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (28, 29),
            (30, 31), (34, 35), (32, 33), (36, 37), (18, 19), (26, 27)]


@dataclass
class Person:
    """One detected person: 18 OpenPose joints (pixel coords) + score."""
    keypoints: np.ndarray               # (18, 2) float, -1 where missing
    visible: np.ndarray                 # (18,) bool
    scores: np.ndarray                  # (18,) float
    total_score: float = 0.0
    total_parts: int = 0
    left_hand: Optional[np.ndarray] = None    # (21, 2) normalized or None
    right_hand: Optional[np.ndarray] = None
    face: Optional[np.ndarray] = None          # (70, 2) normalized or None


def find_peaks(heatmap: np.ndarray, thresh: float,
               sigma: float = 3.0) -> List[List[Tuple]]:
    """Per-part 4-neighbor local maxima of the gaussian-blurred map,
    scored from the UNblurred map, with globally unique ids
    (body.py:106-118)."""
    from scipy.ndimage import gaussian_filter
    all_peaks, count = [], 0
    for part in range(heatmap.shape[2] - 1):        # last ch = background
        raw = heatmap[:, :, part]
        blur = gaussian_filter(raw, sigma=sigma)
        up = np.zeros_like(blur)
        up[1:, :] = blur[:-1, :]
        down = np.zeros_like(blur)
        down[:-1, :] = blur[1:, :]
        left = np.zeros_like(blur)
        left[:, 1:] = blur[:, :-1]
        right = np.zeros_like(blur)
        right[:, :-1] = blur[:, 1:]
        is_peak = ((blur >= up) & (blur >= down) & (blur >= left)
                   & (blur >= right) & (blur > thresh))
        ys, xs = np.nonzero(is_peak)
        peaks = [(x, y, raw[y, x], count + i)
                 for i, (y, x) in enumerate(zip(ys, xs))]
        count += len(peaks)
        all_peaks.append(peaks)
    return all_peaks


def _limb_score(paf_xy: np.ndarray, a, b, img_h: int,
                n_samples: int = 10) -> Tuple[float, int]:
    """Line-integral alignment of the PAF with segment a->b
    (body.py:133-151): mean dot product along n sample points plus a
    length prior, and the count of well-aligned samples."""
    vec = np.array([b[0] - a[0], b[1] - a[1]], np.float64)
    norm = max(1e-3, math.hypot(vec[0], vec[1]))
    u = vec / norm
    xs = np.round(np.linspace(a[0], b[0], n_samples)).astype(int)
    ys = np.round(np.linspace(a[1], b[1], n_samples)).astype(int)
    dots = paf_xy[ys, xs, 0] * u[0] + paf_xy[ys, xs, 1] * u[1]
    prior = min(0.5 * img_h / norm - 1, 0)
    return float(dots.mean() + prior), int((dots > 0.05).sum())


def assemble_people(all_peaks: List[List[Tuple]], paf: np.ndarray,
                    img_h: int) -> Tuple[np.ndarray, np.ndarray]:
    """PAF-scored greedy limb connection + subset growth
    (body.py:120-227). Returns (candidate (K,4) [x,y,score,id],
    subset (P,20) [joint ids..., total_score, n_parts])."""
    connections: List[np.ndarray] = []
    for k, ((ja, jb), (ca, cb)) in enumerate(zip(_LIMBS, _PAF_IDX)):
        cand_a, cand_b = all_peaks[ja], all_peaks[jb]
        if not cand_a or not cand_b:
            connections.append(np.zeros((0, 5)))
            continue
        scored = []
        for i, a in enumerate(cand_a):
            for j, b in enumerate(cand_b):
                s, n_good = _limb_score(paf[:, :, [ca, cb]], a, b, img_h)
                if n_good > 0.8 * 10 and s > 0:
                    scored.append((i, j, s))
        scored.sort(key=lambda t: t[2], reverse=True)
        conn = np.zeros((0, 5))
        used_a, used_b = set(), set()
        for i, j, s in scored:
            if i not in used_a and j not in used_b:
                conn = np.vstack([conn, [cand_a[i][3], cand_b[j][3], s,
                                         i, j]])
                used_a.add(i)
                used_b.add(j)
                if len(conn) >= min(len(cand_a), len(cand_b)):
                    break
        connections.append(conn)

    candidate = np.array([p for peaks in all_peaks for p in peaks],
                         np.float64).reshape(-1, 4)
    subset = -1 * np.ones((0, 20))
    for k, (ja, jb) in enumerate(_LIMBS):
        conn = connections[k]
        if len(conn) == 0:
            continue
        for row in conn:
            id_a, id_b, s = row[0], row[1], row[2]
            hits = [j for j in range(len(subset))
                    if subset[j][ja] == id_a or subset[j][jb] == id_b]
            if len(hits) == 1:
                j = hits[0]
                if subset[j][jb] != id_b:
                    subset[j][jb] = id_b
                    subset[j][-1] += 1
                    subset[j][-2] += candidate[int(id_b), 2] + s
            elif len(hits) >= 2:
                j1, j2 = hits[0], hits[1]
                overlap = ((subset[j1][:-2] >= 0)
                           & (subset[j2][:-2] >= 0)).sum()
                if overlap == 0:            # disjoint people: merge
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += s
                    subset = np.delete(subset, j2, 0)
                else:
                    # NB: unlike the found==1 branch, the reference runs
                    # this unconditionally (body.py:205-208) — no
                    # already-assigned guard
                    subset[j1][jb] = id_b
                    subset[j1][-1] += 1
                    subset[j1][-2] += candidate[int(id_b), 2] + s
            elif k < 17:                    # new person (not ear-shoulder)
                row20 = -1 * np.ones(20)
                row20[ja], row20[jb] = id_a, id_b
                row20[-1] = 2
                row20[-2] = (candidate[int(id_a), 2]
                             + candidate[int(id_b), 2] + s)
                subset = np.vstack([subset, row20])

    keep = [i for i in range(len(subset))
            if subset[i][-1] >= 4 and subset[i][-2] / subset[i][-1] >= 0.4]
    return candidate, subset[keep]


def people_from_subset(candidate: np.ndarray,
                       subset: np.ndarray) -> List[Person]:
    out = []
    for row in subset:
        kpts = -np.ones((18, 2))
        vis = np.zeros(18, bool)
        scr = np.zeros(18)
        for j in range(18):
            idx = int(row[j])
            if idx >= 0:
                kpts[j] = candidate[idx, :2]
                scr[j] = candidate[idx, 2]
                vis[j] = True
        out.append(Person(kpts, vis, scr, float(row[18]), int(row[19])))
    return out


# ---------------------------------------------------------------------------
# hand / face crop boxes from body keypoints (util.py:202-377)
# ---------------------------------------------------------------------------

def hand_boxes(person: Person, img_h: int,
               img_w: int) -> List[Tuple[int, int, int, bool]]:
    """Square wrist-anchored crops, (x, y, size, is_left)."""
    out = []
    for shoulder, elbow, wrist, is_left in ((5, 6, 7, True), (2, 3, 4, False)):
        if not (person.visible[shoulder] and person.visible[elbow]
                and person.visible[wrist]):
            continue
        s, e, w = (person.keypoints[i] for i in (shoulder, elbow, wrist))
        ratio = 0.33
        cx = w[0] + ratio * (w[0] - e[0])
        cy = w[1] + ratio * (w[1] - e[1])
        d_we = math.hypot(*(w - e))
        d_es = math.hypot(*(e - s))
        width = 1.5 * max(d_we, 0.9 * d_es)
        x = max(0.0, cx - width / 2)
        y = max(0.0, cy - width / 2)
        width = min(width,
                    img_w - x if x + width > img_w else width,
                    img_h - y if y + width > img_h else width)
        if width >= 20:
            out.append((int(x), int(y), int(width), is_left))
    return out


def face_box(person: Person, img_h: int,
             img_w: int) -> Optional[Tuple[int, int, int]]:
    """Square nose-anchored crop from eyes/ears (util.py:296-373)."""
    if not person.visible[0]:
        return None
    x0, y0 = person.keypoints[0]
    width = 0.0
    for j, mult in ((14, 3.0), (15, 3.0), (16, 1.5), (17, 1.5)):
        if person.visible[j]:
            x1, y1 = person.keypoints[j]
            width = max(width, max(abs(x0 - x1), abs(y0 - y1)) * mult)
    if width == 0.0:
        return None
    x = max(0.0, x0 - width)
    y = max(0.0, y0 - width)
    # quirk preserved: the reference clamps the 2*width box when the
    # HALF-width point crosses the border (util.py:362-368), not the
    # full box edge
    w1 = w2 = width * 2
    if x + width > img_w:
        w1 = img_w - x
    if y + width > img_h:
        w2 = img_h - y
    w = min(w1, w2)
    return (int(x), int(y), int(w)) if w >= 20 else None


def hand_peaks_from_heatmaps(heatmap: np.ndarray, thresh: float = 0.05,
                             sigma: float = 3.0) -> np.ndarray:
    """Largest-connected-component argmax per hand joint (hand.py:61-80).
    heatmap: (H, W, 22); returns (21, 2) [x, y] with [0, 0] = missing."""
    from scipy.ndimage import gaussian_filter, label
    peaks = []
    eight = np.ones((3, 3), int)
    for part in range(21):
        raw = heatmap[:, :, part].copy()
        blur = gaussian_filter(raw, sigma=sigma)
        binary = blur > thresh
        if not binary.any():
            peaks.append([0, 0])
            continue
        labels, n = label(binary, structure=eight)
        sums = [raw[labels == i].sum() for i in range(1, n + 1)]
        best = int(np.argmax(sums)) + 1
        raw[labels != best] = 0
        y, x = np.unravel_index(np.argmax(raw), raw.shape)
        peaks.append([int(x), int(y)])
    return np.asarray(peaks)


def face_peaks_from_heatmaps(heatmap: np.ndarray,
                             thresh: float = 0.05) -> np.ndarray:
    """Thresholded argmax per landmark (face.py:349-363).
    heatmap: (H, W, 71); returns (N<=70, 2) [x, y]."""
    peaks = []
    for part in range(70):
        m = heatmap[:, :, part]
        mask = m > thresh
        if not mask.any():
            continue
        ys, xs = np.nonzero(mask)
        i = int(np.argmax(m[ys, xs]))
        peaks.append([int(xs[i]), int(ys[i])])
    return np.asarray(peaks, np.float32).reshape(-1, 2)
