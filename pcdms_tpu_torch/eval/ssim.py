"""On-device SSIM for the batch test's best-of-N selection (counterpart of
``pcdms_tpu/eval/ssim_jax.py``).

The host protocol (``eval/metrics.compare_ssim``: uniform 7x7 windows,
reflect padding, an interior crop of (win_size - 1) // 2, sample covariance,
per-channel SSIM averaged) only ever reads the reflected border inside the
crop it discards, so the result is exactly the mean over VALID windows,
which is what this computes with one ``avg_pool2d`` per moment field, in
f32 (the host path is f64: the two can order candidates differently only
where their scores agree to about 1e-6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _mean_valid(x, win: int):
    """VALID-window mean over the spatial dims of (B, C, H, W)."""
    return F.avg_pool2d(x, win, stride=1)


def ssim(x, y, data_range: float = 1.0, win_size: int = 7):
    """Batched SSIM of (B, H, W, C) images in [0, data_range] -> (B,)."""
    x = x.float().permute(0, 3, 1, 2)
    y = y.float().permute(0, 3, 1, 2)
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)            # sample covariance

    ux = _mean_valid(x, win_size)
    uy = _mean_valid(y, win_size)
    uxx = _mean_valid(x * x, win_size)
    uyy = _mean_valid(y * y, win_size)
    uxy = _mean_valid(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))
    return s.mean(dim=(1, 2, 3))
