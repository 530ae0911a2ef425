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

The annotators' operations (controlnet-aux's ``util.py``, OpenPose's
heatmaps, the processors), on (H, W) or (H, W, C) tensors:

  * ``resize`` by area, Lanczos-4 and bilinear on uint8 and f32, bicubic on
    uint8 and f32, bilinear and bicubic on f64: OpenCV's taps and, on
    uint8, its fixed-point sums (equal to cv2 5.0's pixels) but for
    bicubic, which cv2 5.0 sums in f32 (its f32 sums rounded half to even:
    within 1 level on about 1e-5 of the values, the ones whose exact value
    lies within an f32 rounding of a half); f32 bilinear is OpenCV 5's
    pair of fused lerps (equal), the other f32 kinds sum the same taps
    within 2e-6 of OpenCV's largest value; f64 bicubic sums OpenCV's f32
    taps in f64 (equal), f64 bilinear is within 1e-13;
  * ``gaussian_blur``: on uint8 OpenCV's bit-exact fixed-point path
    (equal), on f32 the f32 kernel's sums (within 2e-6), any kernel size
    (above 64 taps by FFT, in f64);
  * ``sobel`` (aperture 3, BORDER_REFLECT_101) on f32 and f64, ``integral``,
    ``convert_scale_abs``, ``threshold_tozero`` and ``bitwise_not``;
  * ``dilate``, ``remap_linear`` (OpenCV 5's f32 path, as the affine
    warp's) and ``canny`` (aperture 3, L1), equal to OpenCV's.
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


# ---------------------------------------------------------------------------
# the annotators' operations: resize (area, Lanczos-4, bicubic, bilinear on
# f32), GaussianBlur, dilate, remap and Canny
# ---------------------------------------------------------------------------

def _hwc(image: torch.Tensor):
    """(H, W) or (H, W, C) -> ((H, W, C) view, whether it had a channel
    axis)."""
    return (image, True) if image.dim() == 3 else (image[..., None], False)


def _unhwc(image: torch.Tensor, had_channels: bool) -> torch.Tensor:
    return image if had_channels else image[..., 0]


def _f32(x) -> np.float32:
    return np.float32(x)


def _cubic_coeffs(x: np.float32):
    """OpenCV's ``interpolateCubic`` (A = -0.75), step for step in f32."""
    a = _f32(-0.75)
    one = _f32(1)
    x1 = x + one
    c0 = ((a * x1 - _f32(5) * a) * x1 + _f32(8) * a) * x1 - _f32(4) * a
    c1 = ((a + _f32(2)) * x - (a + _f32(3))) * x * x + one
    y = one - x
    c2 = ((a + _f32(2)) * y - (a + _f32(3))) * y * y + one
    c3 = one - c0 - c1 - c2
    return [c0, c1, c2, c3]


_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = [(1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0),
               (_S45, _S45), (0, -1), (-_S45, _S45)]


def _lanczos4_coeffs(x: np.float32):
    """OpenCV's ``interpolateLanczos4``: the sines in f64, the sum and the
    normalisation in f32."""
    x3 = float(x + _f32(3))
    y0 = -x3 * np.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    coeffs, total = [], _f32(0)
    for i, (cs0, cs1) in enumerate(_LANCZOS_CS):
        yi = x + _f32(3 - i)
        if abs(yi) >= _f32(1e-6):
            y = -float(yi) * np.pi * 0.25
            c = _f32((cs0 * s0 + cs1 * c0) / (y * y))
        else:
            c = _f32(1e30)
        coeffs.append(c)
        total = _f32(total + c)
    inv = _f32(_f32(1) / total)
    return [_f32(c * inv) for c in coeffs]


_KSIZE = {"linear": 2, "area": 2, "cubic": 4, "lanczos4": 8}


def _generic_taps(src: int, dst: int, kind: str, clamp_border: bool,
                  f32_phase: bool = False):
    """The taps of OpenCV's separable resize (``resizeGeneric``) for one
    axis: -> ((dst, ksize) source indices clamped to the image, (dst,
    ksize) f32 weights). ``kind`` "area" is INTER_AREA where it enlarges
    (bilinear with OpenCV's area-mode phase). ``clamp_border``: the x axis
    of the two-tap kinds moves a tap left of the image onto pixel 0 (and
    right of it onto the last) with weight 0 for its neighbour, as OpenCV
    does for x only. ``f32_phase``: the bicubic phase rounded to f32 first,
    as OpenCV's 64F path takes it."""
    ksize = _KSIZE[kind]
    inv_scale = dst / src
    scale = 1.0 / inv_scale
    idx = np.zeros((dst, ksize), np.int64)
    wts = np.zeros((dst, ksize), np.float32)
    for d in range(dst):
        if kind == "area":
            s = int(np.floor(d * scale))
            f = _f32((d + 1) - (s + 1) * inv_scale)
            f = _f32(0) if f <= 0 else _f32(f - np.floor(f))
        elif kind == "lanczos4":
            pos = _f32((d + 0.5) * scale - 0.5)
            s = int(np.floor(pos))
            f = _f32(pos - _f32(s))
        elif f32_phase:
            pos = _f32((d + 0.5) * scale - 0.5)
            s = int(np.floor(pos))
            f = _f32(pos - _f32(s))
        else:
            # OpenCV 5 takes the bicubic phase in f64 (uint8 and f32)
            pos = (d + 0.5) * scale - 0.5
            s = int(np.floor(pos))
            f = _f32(pos - s)
        if clamp_border and ksize == 2:
            if s < 0:
                f, s = _f32(0), 0
            if s >= src - 1:
                f, s = _f32(0), src - 1
        if kind == "cubic":
            c = _cubic_coeffs(f)
        elif kind == "lanczos4":
            c = _lanczos4_coeffs(f)
        else:
            c = [_f32(1) - f, f]
        first = s - ksize // 2 + 1
        idx[d] = np.clip(np.arange(first, first + ksize), 0, src - 1)
        wts[d] = c
    return idx, wts


def _fixed(wts: np.ndarray) -> np.ndarray:
    """f32 weights -> OpenCV's 11-bit fixed point (``saturate_cast<short>``
    of weight x 2048, rounded half to even)."""
    return np.rint(wts * np.float32(RESIZE_COEF_SCALE)).astype(np.int64)


def _sum_taps(x: torch.Tensor, dim: int, idx: np.ndarray, wts):
    """sum_k x.index_select(dim, idx[:, k]) * wts[:, k], accumulated tap by
    tap in order (OpenCV's ``v = 0; v += S[k] * a[k]``); ``wts`` a tensor
    shaped to broadcast along ``dim``."""
    ix = torch.from_numpy(idx).to(x.device)
    acc = None
    for k in range(idx.shape[1]):
        term = x.index_select(dim, ix[:, k]) * wts[k]
        acc = term if acc is None else acc + term
    return acc


def _weights_along(wts: np.ndarray, dim: int, device, dtype):
    """[(dst,) weights of tap k shaped to broadcast along ``dim`` of an
    (H, W, C) tensor] for every k."""
    shape = [1, 1, 1]
    shape[dim] = -1
    return [torch.from_numpy(np.ascontiguousarray(wts[:, k])).to(
        device=device, dtype=dtype).reshape(shape)
        for k in range(wts.shape[1])]


def _resize_generic(img: torch.Tensor, w: int, h: int, kind: str
                    ) -> torch.Tensor:
    """OpenCV's separable resize of an (H, W, C) uint8, f32 or f64 tensor
    (f64: the f32 taps, summed in f64, as OpenCV's 64F path)."""
    src_h, src_w = img.shape[:2]
    f64 = img.dtype == torch.float64
    xi, xw = _generic_taps(src_w, w, kind, True, f64)
    yi, yw = _generic_taps(src_h, h, kind, False, f64)
    dev = img.device
    if img.dtype in (torch.float32, torch.float64):
        hor = _sum_taps(img, 1, xi, _weights_along(xw, 1, dev, img.dtype))
        return _sum_taps(hor, 0, yi, _weights_along(yw, 0, dev, img.dtype))
    if img.dtype != torch.uint8:
        raise TypeError(f"resize takes uint8, float32 or float64, not "
                        f"{img.dtype}")
    s = img.to(torch.int64)
    hor = _sum_taps(s, 1, xi, _weights_along(_fixed(xw), 1, dev,
                                             torch.int64))
    if xi.shape[1] == 2:
        # the two-tap kinds: OpenCV's vector pass (``resize_linear``)
        b = _weights_along(_fixed(yw), 0, dev, torch.int64)
        ix = torch.from_numpy(yi).to(dev)
        hor = hor >> 4
        out = (((hor.index_select(0, ix[:, 0]) * b[0]) >> 16)
               + ((hor.index_select(0, ix[:, 1]) * b[1]) >> 16) + 2) >> 2
    else:
        out = _sum_taps(hor, 0, yi, _weights_along(_fixed(yw), 0, dev,
                                                   torch.int64))
        out = (out + (1 << 21)) >> 22
    return out.clamp(0, 255).to(torch.uint8)


def _lerp_taps(src: int, dst: int, device):
    """OpenCV 5's f32 bilinear taps: the phase in f64, the two source
    indices clamped to the image, the fraction in f32."""
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    lo = np.floor(pos)
    frac = (pos - lo).astype(np.float32)
    lo = lo.astype(np.int64)
    return [torch.from_numpy(v).to(device) for v in (
        np.clip(lo, 0, src - 1), np.clip(lo + 1, 0, src - 1), frac)]


def _resize_linear_f32(img: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """OpenCV 5's INTER_LINEAR on f32: a lerp along x, then along y, each
    a fused multiply-add (``a + f * (b - a)``, rounded once)."""
    src_h, src_w = img.shape[:2]
    x0, x1, fx = _lerp_taps(src_w, w, img.device)
    y0, y1, fy = _lerp_taps(src_h, h, img.device)
    a, b = img.index_select(1, x0), img.index_select(1, x1)
    hor = _fma(fx[None, :, None], b - a, a)
    a, b = hor.index_select(0, y0), hor.index_select(0, y1)
    return _fma(fy[:, None, None], b - a, a)


def _resize_linear_f64(img: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """INTER_LINEAR on f64: the phase and both weights in f64, the two taps
    of each axis weighted and summed (within 1e-13 of OpenCV's largest
    value)."""
    def taps(src, dst):
        pos = (np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src)
                                                          ) - 0.5
        lo = np.floor(pos)
        frac = pos - lo
        lo = lo.astype(np.int64)
        return [torch.from_numpy(v).to(img.device) for v in (
            np.clip(lo, 0, src - 1), np.clip(lo + 1, 0, src - 1), frac)]
    src_h, src_w = img.shape[:2]
    x0, x1, fx = taps(src_w, w)
    y0, y1, fy = taps(src_h, h)
    fx = fx[None, :, None]
    hor = img.index_select(1, x0) * (1 - fx) + img.index_select(1, x1) * fx
    fy = fy[:, None, None]
    return hor.index_select(0, y0) * (1 - fy) + hor.index_select(0, y1) * fy


def _area_taps(src: int, dst: int, scale: float):
    """OpenCV's ``computeResizeAreaTab`` for one axis: -> ((dst, K) source
    indices, (dst, K) f32 weights), each output's taps in OpenCV's order,
    padded with weight-0 taps."""
    rows = [[] for _ in range(dst)]
    for d in range(dst):
        fsx1 = d * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            rows[d].append((sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for s in range(sx1, sx2):
            rows[d].append((s, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            rows[d].append((sx2, np.float32(
                min(min(fsx2 - sx2, 1.0), cell) / cell)))
    k = max(len(r) for r in rows)
    idx = np.zeros((dst, k), np.int64)
    wts = np.zeros((dst, k), np.float32)
    for d, r in enumerate(rows):
        for j, (s, a) in enumerate(r):
            idx[d, j], wts[d, j] = s, a
    return idx, wts


def _resize_area_down(img: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """OpenCV's INTER_AREA where neither axis enlarges."""
    src_h, src_w = img.shape[:2]
    sx, sy = src_w / w, src_h / h
    isx, isy = int(round(sx)), int(round(sy))
    eps = np.finfo(np.float64).eps
    if abs(sx - isx) < eps and abs(sy - isy) < eps:
        # integer factors (``resizeAreaFast``): block sums
        c = img.shape[2]
        blocks = img.reshape(h, isy, w, isx, c)
        if img.dtype == torch.uint8:
            total = blocks.to(torch.int32).sum(dim=(1, 3))
            if isx == 2 and isy == 2:
                # the SIMD path: a rounding shift
                return ((total + 2) >> 2).to(torch.uint8)
            out = (total.float() * _f32(1.0 / (isx * isy))).round()
            return out.clamp(0, 255).to(torch.uint8)
        total = None
        for j in range(isy):
            for i in range(isx):
                v = blocks[:, j, :, i]
                total = v if total is None else total + v
        return total * _f32(1.0 / (isx * isy))
    xi, xw = _area_taps(src_w, w, sx)
    yi, yw = _area_taps(src_h, h, sy)
    dev = img.device
    hor = _sum_taps(img.float(), 1, xi, _weights_along(xw, 1, dev,
                                                       torch.float32))
    out = _sum_taps(hor, 0, yi, _weights_along(yw, 0, dev, torch.float32))
    if img.dtype == torch.uint8:
        return out.round().clamp(0, 255).to(torch.uint8)
    return out


def resize(image: torch.Tensor, size: Tuple[int, int],
           interpolation: str = "linear") -> torch.Tensor:
    """``cv2.resize(image, size, interpolation=...)`` on an (H, W) or
    (H, W, C) uint8, f32 or f64 tensor; ``size`` is (width, height);
    ``interpolation`` "linear", "area", "cubic" or "lanczos4" (f64:
    "linear" and "cubic").

    uint8: OpenCV's 11-bit fixed-point taps, rounded half to even, summed
    in integers; the vertical pass of the two-tap kinds is ``resize_linear``'s
    vector formula, Lanczos-4's ``(sum + 2^21) >> 22``; INTER_AREA at
    integer factors averages blocks (2x2 by a rounding shift, as OpenCV's
    SIMD path), at other shrinking factors it accumulates its f32 area
    weights tap by tap and rounds half to even. uint8 bicubic is cv2 5.0's
    float path: the f32 taps summed in f32 along x, then along y, rounded
    half to even and saturated (equal but for about 1e-5 of the values, 1
    level off, whose exact value lies within an f32 rounding of a half:
    cv2's sums round in another order there). f32: the same taps in f32,
    summed in OpenCV's order (the card may fuse a product and a sum where
    OpenCV does not: a last-ulp difference). f64: bicubic sums OpenCV's f32
    taps (the phase rounded to f32) in f64 (equal), bilinear takes its
    phase and weights in f64 (within 1e-13). INTER_AREA that enlarges an
    axis is OpenCV's bilinear with the area-mode phase; INTER_LINEAR that
    halves both axes of uint8 is INTER_AREA, as in OpenCV."""
    w, h = size
    img, had_c = _hwc(image)
    src_h, src_w = img.shape[:2]
    if (h, w) == (src_h, src_w):
        return image.clone()
    halves = (src_w == 2 * w and src_h == 2 * h)
    if interpolation == "linear" and halves and img.dtype == torch.uint8:
        interpolation = "area"
    if interpolation == "area" and src_w >= w and src_h >= h:
        out = _resize_area_down(img, w, h)
    elif interpolation == "linear" and img.dtype == torch.uint8:
        out = resize_linear(img, size)
    elif interpolation == "linear" and img.dtype == torch.float32:
        out = _resize_linear_f32(img, w, h)
    elif interpolation == "cubic" and img.dtype == torch.uint8:
        out = _resize_generic(img.float(), w, h, "cubic")
        out = out.round().clamp(0, 255).to(torch.uint8)
    elif img.dtype == torch.float64 and interpolation == "linear":
        out = _resize_linear_f64(img, w, h)
    elif img.dtype == torch.float64 and interpolation != "cubic":
        raise TypeError(f"resize takes float64 with linear or cubic, not "
                        f"{interpolation}")
    elif interpolation in _KSIZE:
        out = _resize_generic(img, w, h, interpolation)
    else:
        raise ValueError(f"unknown interpolation: {interpolation}")
    return _unhwc(out, had_c)


def _gaussian_kernel(sigma: float, ksize: int) -> np.ndarray:
    """OpenCV's ``getGaussianKernelBitExact``: exp(-x^2 / (2 sigma^2))
    over ``ksize`` taps, normalised to sum 1, in f64."""
    scale2x = -0.125 / (sigma * sigma)
    half = (ksize - 1) // 2
    values = [np.exp(float(x * x) * scale2x)
              for x in range(1 - ksize, 0, 2)][:half]
    total = 2.0 * sum(values) + 1.0
    side = [v / total for v in values]
    return np.asarray(side + [1.0 / total] + side[::-1], np.float64)


def _gaussian_fixed(kernel: np.ndarray, bits: int = 8) -> np.ndarray:
    """OpenCV's ``getGaussianKernelFixedPoint_ED``: each side tap rounded
    to ``bits`` fraction bits with the rounding error carried to the next,
    the centre taking what makes the sum exactly one."""
    one = float(1 << bits)
    n, half = len(kernel), len(kernel) // 2
    out = np.zeros(n, np.int64)
    err = 0.0
    for i in range(half):
        adj = kernel[i] * one + err
        v = int(np.rint(adj))
        err = adj - v
        out[i] = out[n - 1 - i] = v
    out[half] = int(np.rint(one - 2 * out[:half].sum()))
    return out


def _reflect101(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of an axis of length ``n`` padded by ``pad`` on both
    sides with BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba)."""
    i = np.arange(-pad, n + pad)
    if n == 1:
        return torch.zeros(len(i), dtype=torch.int64, device=device)
    period = 2 * n - 2
    i = np.abs(np.mod(i, period))
    i = np.where(i >= n, period - i, i)
    return torch.from_numpy(i).to(device)


# above this many taps the f32 blur convolves by FFT
FFT_BLUR_TAPS = 64


def _blur_fft(img: torch.Tensor, kernel: np.ndarray, dim: int
              ) -> torch.Tensor:
    """The f64 kernel along ``dim`` of an (H, W, C) tensor, BORDER_REFLECT_101,
    by an f64 FFT (the row pass's result rounded to f32, as OpenCV keeps its
    row buffer) -> f64."""
    n, ksize = img.shape[dim], len(kernel)
    x = img.double().index_select(dim, _reflect101(n, ksize // 2, img.device))
    nfft = 1 << int(np.ceil(np.log2(x.shape[dim] + ksize)))
    k = torch.from_numpy(kernel[::-1].copy()).to(img.device)
    shape = [1, 1, 1]
    shape[dim] = -1
    y = torch.fft.irfft(torch.fft.rfft(x, nfft, dim=dim)
                        * torch.fft.rfft(k, nfft).reshape(shape), nfft,
                        dim=dim).narrow(dim, ksize - 1, n)
    return y.float().double() if dim == 1 else y


def gaussian_blur(image: torch.Tensor, sigma: float,
                  ksize: int = 0) -> torch.Tensor:
    """``cv2.GaussianBlur(image, (ksize, ksize), sigma)`` on an (H, W) or
    (H, W, C) uint8 or f32 tensor: a separable kernel of ``ksize`` taps (0:
    ``round(sigma * 6 + 1) | 1`` taps on uint8, ``* 8`` on f32),
    BORDER_REFLECT_101. uint8 is OpenCV's bit-exact path: the kernel in 8
    fraction bits with its error carried, the rows in 16-bit fixed point,
    the columns in 32-bit, rounded half up; f32 sums the f32 kernel's
    products tap by tap, or, above ``FFT_BLUR_TAPS`` taps, convolves with
    the f64 kernel by FFT in f64 (within 1.1e-6 of cv2's largest value at
    749 taps; the tap loop would take minutes there on a CPU)."""
    img, had_c = _hwc(image)
    depth_mult = 3 if img.dtype == torch.uint8 else 4
    if not ksize:
        ksize = int(np.rint(sigma * depth_mult * 2 + 1)) | 1
    kernel = _gaussian_kernel(sigma, ksize)
    pad = ksize // 2
    h, w = img.shape[:2]
    dev = img.device
    rows, cols = _reflect101(h, pad, dev), _reflect101(w, pad, dev)
    idx_x = np.arange(w)[:, None] + np.arange(ksize)[None]
    idx_y = np.arange(h)[:, None] + np.arange(ksize)[None]
    if img.dtype == torch.uint8:
        k = _gaussian_fixed(kernel)
        x = img.to(torch.int64).index_select(1, cols)
        hor = _sum_taps(x, 1, idx_x, _weights_along(
            np.tile(k, (w, 1)), 1, dev, torch.int64))
        out = _sum_taps(hor.index_select(0, rows), 0, idx_y, _weights_along(
            np.tile(k, (h, 1)), 0, dev, torch.int64))
        out = ((out + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8)
    elif img.dtype == torch.float32 and ksize > FFT_BLUR_TAPS:
        out = _blur_fft(_blur_fft(img, kernel, 1), kernel, 0).float()
    elif img.dtype == torch.float32:
        k = kernel.astype(np.float32)
        x = img.index_select(1, cols)
        hor = _sum_taps(x, 1, idx_x, _weights_along(
            np.tile(k, (w, 1)), 1, dev, torch.float32))
        out = _sum_taps(hor.index_select(0, rows), 0, idx_y, _weights_along(
            np.tile(k, (h, 1)), 0, dev, torch.float32))
    else:
        raise TypeError(f"gaussian_blur takes uint8 or float32, not "
                        f"{img.dtype}")
    return _unhwc(out, had_c)


def sobel(image: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """``cv2.Sobel(image, <its depth>, dx, dy, ksize=3)`` on an (H, W) f32
    or f64 tensor, BORDER_REFLECT_101: ``(dx, dy)`` (1, 0) or (0, 1). The
    derivative pass is a difference, the smoothing pass ``(a + c) + 2 b``,
    OpenCV's symmetric-kernel order (``(a + 2 b) + c`` along the rows of
    f64): equal to cv2 on f64; on f32 equal but for the few columns that
    cv2 takes outside its vector loop, within an ulp of their magnitude."""
    if (dx, dy) not in ((1, 0), (0, 1)):
        raise ValueError("sobel takes (dx, dy) (1, 0) or (0, 1)")
    h, w = image.shape
    dev = image.device
    p = image.index_select(0, _reflect101(h, 1, dev)).index_select(
        1, _reflect101(w, 1, dev))
    if dx:
        r = p[:, 2:] - p[:, :-2]
        return (r[:-2] + r[2:]) + r[1:-1] * 2
    if image.dtype == torch.float64:
        r = (p[:, :-2] + p[:, 1:-1] * 2) + p[:, 2:]
    else:
        r = (p[:, :-2] + p[:, 2:]) + p[:, 1:-1] * 2
    return r[2:] - r[:-2]


def integral(image: torch.Tensor) -> torch.Tensor:
    """``cv2.integral`` of an (H, W) f64 tensor: the (H + 1, W + 1) sums of
    every top-left rectangle, a zero first row and column; each row's
    running sum added to the row above, as OpenCV accumulates."""
    h, w = image.shape
    out = image.new_zeros((h + 1, w + 1))
    out[1:, 1:] = image.cumsum(1).cumsum(0)
    return out


def convert_scale_abs(image: torch.Tensor, alpha: float) -> torch.Tensor:
    """``cv2.convertScaleAbs(image, alpha=alpha)``: ``|x * alpha|`` in f32,
    rounded half to even and saturated to uint8."""
    out = (image.float() * np.float32(alpha)).abs().round()
    return out.clamp(0, 255).to(torch.uint8)


def threshold_tozero(image: torch.Tensor, thresh: float) -> torch.Tensor:
    """``cv2.threshold(image, thresh, 255, cv2.THRESH_TOZERO)[1]`` on uint8:
    a value above ``floor(thresh)`` kept, the rest 0 (OpenCV floors the
    threshold of 8-bit images)."""
    return torch.where(image.to(torch.int32) > int(np.floor(thresh)), image,
                       torch.zeros_like(image))


def bitwise_not(image: torch.Tensor) -> torch.Tensor:
    """``cv2.bitwise_not`` of a uint8 tensor."""
    return 255 - image


def dilate(image: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """``cv2.dilate(image, kernel)``: the maximum over the kernel's non-zero
    taps (anchor at its centre), outside the image ignored, on an (H, W) or
    (H, W, C) tensor of any dtype."""
    img, had_c = _hwc(image)
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    h, w = img.shape[:2]
    out = None
    for dy, dx in zip(*np.nonzero(kernel)):
        oy, ox = int(dy) - ay, int(dx) - ax
        y0, y1 = max(0, -oy), min(h, h - oy)
        x0, x1 = max(0, -ox), min(w, w - ox)
        if y0 >= y1 or x0 >= x1:
            continue
        shifted = torch.full_like(img, _lowest(img.dtype))
        shifted[y0:y1, x0:x1] = img[y0 + oy:y1 + oy, x0 + ox:x1 + ox]
        out = shifted if out is None else torch.maximum(out, shifted)
    return _unhwc(img.clone() if out is None else out, had_c)


def _lowest(dtype):
    return (torch.iinfo(dtype).min if not dtype.is_floating_point
            else float("-inf"))


def remap_linear(image: torch.Tensor, map_x: torch.Tensor,
                 map_y: torch.Tensor) -> torch.Tensor:
    """``cv2.remap(image, map_x, map_y, cv2.INTER_LINEAR)`` (constant
    border 0) on an (H, W, C) uint8 tensor with f32 (H', W') maps: OpenCV
    5's f32 path, as ``warp_affine_linear``'s: the floor and fraction of
    each source position, two lerps along x and one along y, each a fused
    multiply-add in f32, rounded half to even; a tap outside the image
    reads 0."""
    img, had_c = _hwc(image)
    src_h, src_w = img.shape[:2]
    sx, sy = map_x.float(), map_y.float()
    fx, fy = sx.floor(), sy.floor()
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    ix, iy = fx.long(), fy.long()
    src = img.float()
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
    return _unhwc(out.round().clamp(0, 255).to(torch.uint8), had_c)


_TG22 = 13573              # tan(22.5 deg) in 15 fraction bits (OpenCV)


def canny(image: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """``cv2.Canny(image, low, high)`` (aperture 3, L1 gradient) on an
    (H, W) or (H, W, C) uint8 tensor -> (H, W) uint8 in {0, 255}.

    The 3x3 Sobel derivatives of each channel with the border replicated,
    per pixel the channel of the largest |dx| + |dy| (the first on ties),
    OpenCV's integer non-maximum suppression along the gradient's octant
    (strictly above one neighbour, at least the other), then hysteresis:
    a candidate above ``floor(low)`` is an edge when its 8-connected
    component of candidates holds one above ``floor(high)``. The gradient
    and the suppression run on the tensor's device, the components on the
    host (scipy)."""
    from scipy.ndimage import label
    img, _ = _hwc(image)
    if low > high:
        low, high = high, low
    lo, hi = int(np.floor(low)), int(np.floor(high))
    h, w = img.shape[:2]
    dev = img.device
    rows = torch.arange(-1, h + 1, device=dev).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=dev).clamp(0, w - 1)
    p = img.to(torch.int32).index_select(0, rows).index_select(1, cols)

    def at(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    dx = ((at(-1, 1) - at(-1, -1)) + 2 * (at(0, 1) - at(0, -1))
          + (at(1, 1) - at(1, -1)))
    dy = ((at(1, -1) - at(-1, -1)) + 2 * (at(1, 0) - at(-1, 0))
          + (at(1, 1) - at(-1, 1)))
    mag = dx.abs() + dy.abs()
    best = torch.zeros((h, w), dtype=torch.int64, device=dev)
    for c in range(1, img.shape[2]):
        best = torch.where(mag[..., c] > mag.gather(
            2, best[..., None])[..., 0], torch.full_like(best, c), best)
    pick = best[..., None]
    mag = mag.gather(2, pick)[..., 0]
    dx, dy = dx.gather(2, pick)[..., 0], dy.gather(2, pick)[..., 0]

    m = torch.nn.functional.pad(mag, (1, 1, 1, 1))

    def nb(oy, ox):
        return m[1 + oy:1 + oy + h, 1 + ox:1 + ox + w]
    ax = dx.abs().long()
    ay = dy.abs().long() << 15
    tg22 = ax * _TG22
    tg67 = tg22 + (ax << 16)
    s = torch.where((dx ^ dy) < 0, -1, 1)
    horiz = (mag > nb(0, -1)) & (mag >= nb(0, 1))
    vert = (mag > nb(-1, 0)) & (mag >= nb(1, 0))
    # the diagonal octants: above-left / below-right when dx and dy share
    # a sign, else above-right / below-left
    diag_pos = (mag > nb(-1, -1)) & (mag > nb(1, 1))
    diag_neg = (mag > nb(-1, 1)) & (mag > nb(1, -1))
    diag = torch.where(s < 0, diag_neg, diag_pos)
    keep = torch.where(ay < tg22, horiz, torch.where(ay > tg67, vert, diag))
    cand = (keep & (mag > lo)).cpu().numpy()
    strong = cand & (mag > hi).cpu().numpy()
    labels, _ = label(cand, structure=np.ones((3, 3), int))
    seeds = np.unique(labels[strong])
    edges = np.isin(labels, seeds[seeds > 0])
    return torch.from_numpy(edges.astype(np.uint8) * 255).to(dev)
