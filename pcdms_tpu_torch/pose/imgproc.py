"""The image operations of the DWPose protocol, in PyTorch, without cv2.

The JAX package's ``pose/dwpose.py`` letterboxes with ``cv2.resize``
(``INTER_LINEAR``), crops each person with ``cv2.getAffineTransform`` and
``cv2.warpAffine`` (bilinear, constant border 0), maps the keypoints back
with ``cv2.invertAffineTransform`` and swaps RGB to BGR with
``cv2.cvtColor``. This module does what OpenCV 5.0 does there, bit for bit
on (H, W, C) uint8 image tensors on any device (every product and sum is
its own elementwise operation, so no device fuses two roundings into one):

  * ``resize_linear``: the source position of each output row and column in
    f32, its two taps' weights rounded to 11 bits
    (``INTER_RESIZE_COEF_SCALE``), the horizontal pass in integers, the
    vertical pass as OpenCV's vector code computes it
    (``((s0 >> 4) * b0 >> 16) + ((s1 >> 4) * b1 >> 16)``, then ``+ 2 >> 2``).
    The tap indices are clamped to the image, the weights are not: at a
    border both taps read the edge pixel;
  * ``warp_affine_linear``: OpenCV's vector path of ``warpAffine``: the
    inverse map in f32 (the row's offset rounded once, each pixel's source
    position by a fused multiply-add), then two lerps along x and one along
    y, each a fused multiply-add in f32, rounded half to even; a tap
    outside the image reads 0. A fused multiply-add of f32 operands is their
    product in f64 (exact) plus the addend in f64, rounded to f32;
  * ``get_affine_transform``: OpenCV's 6x6 LU solve with partial pivoting,
    step for step in f64; ``invert_affine_transform`` its 2x3 inverse.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

RESIZE_COEF_SCALE = 2048          # INTER_RESIZE_COEF_SCALE, 11 bits


def swap_rb(image: torch.Tensor) -> torch.Tensor:
    """RGB <-> BGR (``cv2.cvtColor`` with COLOR_RGB2BGR / COLOR_BGR2RGB)."""
    return image.flip(-1)


def _linear_taps(src: int, dst: int, device):
    """-> the two (clamped) source indices and their 11-bit weights for each
    of ``dst`` outputs resized from ``src``."""
    scale = 1.0 / (dst / src)
    pos = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
           ).astype(np.float32)
    lo = np.floor(pos)
    frac = (pos - lo).astype(np.float32)
    lo = lo.astype(np.int64)
    w1 = np.rint(frac * np.float32(RESIZE_COEF_SCALE))
    w0 = np.rint((np.float32(1) - frac) * np.float32(RESIZE_COEF_SCALE))
    return [torch.from_numpy(v).to(device) for v in (
        np.clip(lo, 0, src - 1), np.clip(lo + 1, 0, src - 1),
        w0.astype(np.int32), w1.astype(np.int32))]


def resize_linear(image: torch.Tensor, size: Tuple[int, int]
                  ) -> torch.Tensor:
    """``cv2.resize(image, size, interpolation=cv2.INTER_LINEAR)`` on an
    (H, W, C) uint8 tensor; ``size`` is (width, height)."""
    w, h = size
    src_h, src_w = image.shape[:2]
    if (h, w) == (src_h, src_w):
        return image.clone()
    x0, x1, a0, a1 = _linear_taps(src_w, w, image.device)
    y0, y1, b0, b1 = _linear_taps(src_h, h, image.device)
    s = image.to(torch.int32)
    hor = (s.index_select(1, x0) * a0[:, None]
           + s.index_select(1, x1) * a1[:, None]) >> 4
    out = (((hor.index_select(0, y0) * b0[:, None, None]) >> 16)
           + ((hor.index_select(0, y1) * b1[:, None, None]) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _inverse_2x3(m: Sequence[float]):
    """OpenCV's 2x3 affine inverse in f64, as ``warpAffine`` and
    ``invertAffineTransform`` compute it."""
    m0, m1, m2, m3, m4, m5 = (float(v) for v in m)
    d = m0 * m4 - m1 * m3
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m4 * d, m0 * d, -m1 * d, -m3 * d
    return (a11, a12, -a11 * m2 - a12 * m5,
            a21, a22, -a21 * m2 - a22 * m5)


def warp_affine_linear(image: torch.Tensor, mat: np.ndarray,
                       size: Tuple[int, int]) -> torch.Tensor:
    """``cv2.warpAffine(image, mat, size)`` (bilinear, constant border 0) on
    an (H, W, C) uint8 tensor; ``size`` is (width, height)."""
    w, h = size
    src_h, src_w = image.shape[:2]
    dev = image.device
    m = torch.tensor(_inverse_2x3(np.asarray(mat).ravel()),
                     dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    sx = _fma(m[0], xs, ys * m[1] + m[2])
    sy = _fma(m[3], xs, ys * m[4] + m[5])
    fx, fy = sx.floor(), sy.floor()
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    ix, iy = fx.long(), fy.long()
    src = image.float()
    zero = src.new_zeros(())

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < src_w) & (yy >= 0) & (yy < src_h)
        v = src[yy.clamp(0, src_h - 1), xx.clamp(0, src_w - 1)]
        return torch.where(inside[..., None], v, zero)

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    top = _fma(ax, p01 - p00, p00)
    bottom = _fma(ax, p11 - p10, p10)
    out = _fma(ay, bottom - top, top)
    return out.round().clamp(0, 255).to(torch.uint8)


def get_affine_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getAffineTransform``: the (2, 3) f64 map of three points
    ``src`` onto ``dst`` (each (3, 2), read as f32 points), by OpenCV's LU
    solve of the 6x6 system; zeros when the source points are collinear."""
    src = np.asarray(src, np.float32).astype(np.float64)
    dst = np.asarray(dst, np.float32).astype(np.float64)
    a = [[0.0] * 6 for _ in range(6)]
    b = [0.0] * 6
    for i in range(3):
        x, y = float(src[i, 0]), float(src[i, 1])
        a[2 * i][:3] = [x, y, 1.0]
        a[2 * i + 1][3:] = [x, y, 1.0]
        b[2 * i], b[2 * i + 1] = float(dst[i, 0]), float(dst[i, 1])
    n = 6
    for i in range(n):
        k = i
        for j in range(i + 1, n):
            if abs(a[j][i]) > abs(a[k][i]):
                k = j
        if abs(a[k][i]) < np.finfo(np.float64).eps * 100:
            return np.zeros((2, 3), np.float64)     # singular, as OpenCV
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, n):
            alpha = a[j][i] * d
            for c in range(i + 1, n):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(n - 1, -1, -1):
        s = b[i]
        for c in range(i + 1, n):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return np.asarray(b, np.float64).reshape(2, 3)


def invert_affine_transform(mat: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` of a (2, 3) f64 map."""
    return np.asarray(_inverse_2x3(np.asarray(mat, np.float64).ravel()),
                      np.float64).reshape(2, 3)
