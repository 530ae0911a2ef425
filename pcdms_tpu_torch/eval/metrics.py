"""Host metrics of the batch-test protocol (the port's own copies from
``pcdms_tpu/eval/metrics.py``): ``compare_ssim`` / ``_ssim_single``, with
skimage ``structural_similarity`` semantics, per-channel 2D windows
averaged over channels, K1 = 0.01 / K2 = 0.03, an edge crop of
(win_size - 1) // 2, gaussian truncate 3.5, in f64; and the stage-1
batch test's ``cosine_similarity``."""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def _ssim_single(x: np.ndarray, y: np.ndarray, data_range: float,
                 win_size: int, gaussian_weights: bool, sigma: float,
                 use_sample_covariance: bool) -> float:
    """skimage-compatible single-channel SSIM."""
    x = x.astype(np.float64)
    y = y.astype(np.float64)

    if gaussian_weights:
        truncate = 3.5
        r = int(truncate * sigma + 0.5)
        win_size = 2 * r + 1

        def filt(im):
            return ndimage.gaussian_filter(im, sigma=sigma,
                                           truncate=truncate, mode="reflect")
    else:
        def filt(im):
            return ndimage.uniform_filter(im, size=win_size, mode="reflect")

    if any(s < win_size for s in x.shape):
        raise ValueError(
            f"win_size={win_size} exceeds image extent {x.shape}; use "
            "smaller win_size or larger images")

    np_ = win_size ** x.ndim
    cov_norm = np_ / (np_ - 1) if use_sample_covariance else 1.0

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))

    pad = (win_size - 1) // 2
    inner = s[tuple(slice(pad, n - pad) for n in s.shape)]
    return float(inner.mean())


def compare_ssim(img_true: np.ndarray, img_test: np.ndarray,
                 data_range: float = 1.0, win_size: int = 7,
                 gaussian_weights: bool = False, sigma: float = 1.5,
                 use_sample_covariance: bool = True,
                 multichannel: bool = True) -> float:
    """Multichannel SSIM = mean of per-channel SSIM (channel_axis=-1)."""
    if multichannel and img_true.ndim == 3:
        return float(np.mean([
            _ssim_single(img_true[..., c], img_test[..., c], data_range,
                         win_size, gaussian_weights, sigma,
                         use_sample_covariance)
            for c in range(img_true.shape[-1])]))
    return _ssim_single(img_true, img_test, data_range, win_size,
                        gaussian_weights, sigma, use_sample_covariance)


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise cosine similarity in f64 (the stage-1 batch test's
    score)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    num = np.sum(a * b, axis=-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return num / np.maximum(den, 1e-12)
