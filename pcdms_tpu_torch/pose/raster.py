"""Integer rasterisation of the OpenPose drawing convention, without cv2.

The skeleton renders the stage-2 UNet was trained on, and the synthetic
world's person images, are drawn by OpenCV's ``ellipse2Poly``,
``fillConvexPoly`` and filled ``circle``. This module does what those do,
pixel for pixel, in numpy and Python integers:

  * ``ellipse2poly``: the whole ellipse's outline at every integer degree
    from OpenCV's table of sines (7 decimals, stored as f32), the points
    rounded half to even and consecutive repeats dropped;
  * ``fill_convex_poly`` (shift 0, 8-connected): every edge drawn as an
    8-connected Bresenham line (clipped to the image first), then the rows
    between the left and right edges filled from their 16.16 fixed-point
    x, stepped once per row from the edge's upper vertex;
  * ``fill_circle``: the midpoint circle's horizontal spans.

Each draws into an (H, W, C) uint8 canvas in place, clipped to it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
# sin(i degrees), i = 0 .. 450, to 7 decimals in f32: OpenCV's table
SIN_TABLE = [float(v) for v in np.round(
    np.sin(np.deg2rad(np.arange(451))), 7).astype(np.float32)]

Point = Tuple[int, int]


def ellipse2poly(center: Point, axes: Point, angle: int) -> List[Point]:
    """The whole outline of the ellipse of integer ``center`` (x, y),
    half-axes ``axes`` and rotation ``angle`` (degrees) at 1-degree steps,
    as integer points: ``cv2.ellipse2Poly(center, axes, angle, 0, 360, 1)``.
    """
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    alpha, beta = SIN_TABLE[450 - angle], SIN_TABLE[angle]
    cx, cy = float(center[0]), float(center[1])
    ax, ay = float(axes[0]), float(axes[1])
    pts: List[Point] = []
    for a in range(0, 361):
        x = ax * SIN_TABLE[450 - a]
        y = ay * SIN_TABLE[a]
        # Python's round() is half to even, as cvRound on x86-64
        pt = (round(cx + x * alpha - y * beta),
              round(cy + x * beta + y * alpha))
        if not pts or pt != pts[-1]:
            pts.append(pt)
    if len(pts) == 1:
        pts = [tuple(center), tuple(center)]
    return pts


def _clip_line(w: int, h: int, p1: Point, p2: Point):
    """Cohen-Sutherland clip of the segment to [0, w) x [0, h), as OpenCV's
    ``clipLine``; -> the clipped ends, or None if nothing is inside."""
    x1, y1 = p1
    x2, y2 = p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def line_pixels(w: int, h: int, p1: Point, p2: Point) -> List[Point]:
    """The pixels of the 8-connected line from ``p1`` to ``p2`` inside a
    w x h image (OpenCV's ``LineIterator``, left to right)."""
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h):
        clipped = _clip_line(w, h, p1, p2)
        if clipped is None:
            return []
        p1, p2 = clipped
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    (x, y), dx, dy = p1, p2[0] - p1[0], p2[1] - p1[1]
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    err = major - 2 * minor
    out = []
    for _ in range(major + 1):
        out.append((x, y))
        step_minor = err < 0
        err += -2 * minor + (2 * major if step_minor else 0)
        if vert:
            y += sy
            x += step_minor
        else:
            x += 1
            y += sy if step_minor else 0
    return out


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def fill_convex_poly(canvas: np.ndarray, pts: Sequence[Point], color
                     ) -> np.ndarray:
    """Fill the convex polygon ``pts`` (integer (x, y)) with ``color`` in
    place: its edges as 8-connected lines, then the spans between them."""
    h, w = canvas.shape[:2]
    v = [(int(x), int(y)) for x, y in pts]
    npts = len(v)
    if npts == 0:
        return canvas
    color = np.asarray(color, canvas.dtype)[:canvas.shape[2]]
    p0 = v[-1]
    for p in v:
        for x, y in line_pixels(w, h, p0, p):
            canvas[y, x] = color
        p0 = p
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    ymin, ymax = min(ys), max(ys)
    if npts < 3 or max(xs) < 0 or ymax < 0 or min(xs) >= w or ymin >= h:
        return canvas
    ymax = min(ymax, h - 1)
    imin = ys.index(ymin)
    edges = npts
    e_idx, e_di = [imin, imin], [1, npts - 1]
    e_x, e_dx, e_ye = [-XY_ONE, -XY_ONE], [0, 0], [ymin, ymin]
    half = XY_ONE >> 1
    y = ymin
    while True:
        for i in (0, 1):
            if y < e_ye[i]:
                continue
            idx0, di = e_idx[i], e_di[i]
            idx = idx0 + di
            if idx >= npts:
                idx -= npts
            while True:
                more = edges > 0
                edges -= 1
                if not more:
                    break
                ty = v[idx][1]
                if ty > y:
                    xs0, xe = v[idx0][0] << XY_SHIFT, v[idx][0] << XY_SHIFT
                    e_ye[i] = ty
                    e_dx[i] = _cdiv((xe - xs0) * 2 + (ty - y), 2 * (ty - y))
                    e_x[i] = xs0
                    e_idx[i] = idx
                    break
                idx0 = idx
                idx += di
                if idx >= npts:
                    idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if e_x[0] > e_x[1] else (0, 1)
            x1 = (e_x[left] + half) >> XY_SHIFT
            x2 = (e_x[right] + half) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                canvas[y, max(x1, 0):min(x2, w - 1) + 1] = color
        e_x[0] += e_dx[0]
        e_x[1] += e_dx[1]
        y += 1
        if y > ymax:
            break
    return canvas


def fill_circle(canvas: np.ndarray, center: Point, radius: int, color
                ) -> np.ndarray:
    """The filled midpoint circle (OpenCV's ``circle`` with thickness -1,
    8-connected, shift 0) in place, clipped to the canvas."""
    h, w = canvas.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    color = np.asarray(color, canvas.dtype)[:canvas.shape[2]]

    def span(y, x1, x2):
        if 0 <= y < h and x1 < w and x2 >= 0:
            canvas[y, max(x1, 0):min(x2, w - 1) + 1] = color

    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y in (cy - dy, cy + dy):
            span(y, cx - dx, cx + dx)
        for y in (cy - dx, cy + dx):
            span(y, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return canvas
