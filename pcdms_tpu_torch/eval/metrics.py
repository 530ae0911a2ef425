"""Host metrics of the evaluation protocol (the port's own copies from
``pcdms_tpu/eval/metrics.py``), the reference's ``metrics.py`` and
``caculate_metrics_{256,512}.py`` without torchvision or skimage:

  * PSNR / L1 / MAE on [0, 1] bicubic-resized images (176x256 or 352x512);
  * SSIM with skimage ``structural_similarity`` semantics (per-channel 2D
    windows averaged over channels, K1 = 0.01 / K2 = 0.03, an edge crop of
    (win_size - 1) // 2, gaussian truncate 3.5, in f64), in the protocol's
    two variants: a uniform 51x51 window with sample covariance on [0, 1]
    images, and ``ssim_256``: gaussian weights of sigma 1.2, population
    covariance, on 0-255 images with data_range = pred.max() - pred.min();
  * FID from a pluggable 2048-d feature function (``eval/inception.py``),
    per-directory mu / sigma cached to ``{W}_{H}_statistics.npz``, the
    Frechet distance with the sqrtm eps-offset retry;
  * the ``{src}_to_{tgt}`` filename pairing and the per-example
    ``{W}_{H}_metrics.npz`` cache;
  * the stage-1 batch test's ``cosine_similarity``.

The caches have the JAX package's names, keys and dtypes, so either package
reads the other's. Images are resized by ``_load_resized``: PyTorch's
bicubic (A = -0.75, clamped edges) in f32, where the JAX package calls
``cv2.resize(INTER_CUBIC)``; the two differ by about 4e-5 in [0, 1] units.
"""

from __future__ import annotations

import glob
import os
import warnings
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import linalg, ndimage


def compare_psnr(img_true: np.ndarray, img_test: np.ndarray,
                 data_range: float = 1.0) -> float:
    err = np.mean((img_true.astype(np.float64)
                   - img_test.astype(np.float64)) ** 2)
    if err == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range ** 2) / err))


def compare_l1(img_true: np.ndarray, img_test: np.ndarray) -> float:
    return float(np.mean(np.abs(img_true.astype(np.float32)
                                - img_test.astype(np.float32))))


def compare_mae(img_true: np.ndarray, img_test: np.ndarray) -> float:
    """The reference's 'mae': sum|a - b| / sum(a + b)."""
    a = img_true.astype(np.float32)
    b = img_test.astype(np.float32)
    return float(np.sum(np.abs(a - b)) / np.sum(a + b))


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


# ---------------------------------------------------------------------------
# file handling
# ---------------------------------------------------------------------------

def get_image_list(flist) -> List[str]:
    if isinstance(flist, (list, tuple, np.ndarray)):
        return list(flist)
    if os.path.isdir(flist):
        files = glob.glob(os.path.join(flist, "*.jpg")) + \
            glob.glob(os.path.join(flist, "*.png"))
        return sorted(files)
    if os.path.isfile(flist):
        return [flist]
    return []


def preprocess_path_for_deform_task(gt_path: str, distorted_path):
    """Pair generated '{src}_to_{tgt}' files with their GT images: drop the
    basename's first character, keep what follows the last '_to_', map
    .jpg to .png; generated files without a GT image are left out."""
    distorted_list = sorted(get_image_list(distorted_path))
    gt_list, kept = [], []
    for f in distorted_list:
        name = os.path.basename(f)[1:]
        name = name.split("_to_")[-1]
        gt_image = os.path.join(gt_path, name.replace("jpg", "png"))
        if not os.path.isfile(gt_image):
            continue
        gt_list.append(gt_image)
        kept.append(f)
    return gt_list, kept


def _load_resized(path: str, img_size: Tuple[int, int]) -> np.ndarray:
    """RGB image -> bicubic resize to ``img_size`` = (W, H) in f32 on
    0-255 values, then / 255: (H, W, 3) f32."""
    from PIL import Image
    img = np.array(Image.open(path).convert("RGB"), np.float32)
    x = torch.from_numpy(img).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(img_size[1], img_size[0]), mode="bicubic",
                      align_corners=False)
    return x[0].permute(1, 2, 0).numpy() / 255.0


# ---------------------------------------------------------------------------
# reconstruction harness
# ---------------------------------------------------------------------------

_KEYS = ("psnr", "ssim", "ssim_256", "mae", "l1")


class ReconstructionMetrics:
    def __init__(self, data_range: float = 1.0, win_size: int = 51,
                 multichannel: bool = True):
        self.data_range = data_range
        self.win_size = win_size
        self.multichannel = multichannel

    def compute_pair(self, img_gt: np.ndarray, img_pred: np.ndarray):
        """Images in [0, 1], (H, W, 3)."""
        out = {
            "psnr": compare_psnr(img_gt, img_pred, self.data_range),
            "ssim": compare_ssim(img_gt, img_pred, self.data_range,
                                 win_size=self.win_size,
                                 multichannel=self.multichannel),
            "l1": compare_l1(img_gt, img_pred),
            "mae": compare_mae(img_gt, img_pred),
        }
        g255, p255 = img_gt * 255.0, img_pred * 255.0
        out["ssim_256"] = compare_ssim(
            g255, p255, data_range=float(p255.max() - p255.min()),
            gaussian_weights=True, sigma=1.2, use_sample_covariance=False,
            multichannel=True)
        return out

    def calculate_from_disk(self, inputs, gts, save_path: Optional[str] = None,
                            img_size: Tuple[int, int] = (176, 256),
                            sort: bool = True):
        """Mean and variance of each metric over the (input, GT) pairs, as
        {name: [value]}, rounded to 6 decimals; per-pair values cached in
        ``save_path/{W}_{H}_metrics.npz`` and read from there if present."""
        input_list = sorted(get_image_list(inputs)) if sort \
            else get_image_list(inputs)
        gt_list = sorted(get_image_list(gts)) if sort else get_image_list(gts)

        npz_file = (os.path.join(save_path,
                                 f"{img_size[0]}_{img_size[1]}_metrics.npz")
                    if save_path else None)
        if npz_file and os.path.exists(npz_file):
            f = np.load(npz_file)
            vals = {k: f[k] for k in _KEYS}
        else:
            if not input_list or not gt_list:
                raise ValueError(
                    "no generated/GT image pairs to score (check the "
                    "'_to_' filename pairing and directory paths)")
            vals = {k: [] for k in _KEYS}
            for pred_path, gt_path in zip(input_list, gt_list):
                pair = self.compute_pair(_load_resized(gt_path, img_size),
                                         _load_resized(pred_path, img_size))
                for k in vals:
                    vals[k].append(pair[k])
            if npz_file:
                np.savez(npz_file, **{k: np.asarray(v)
                                      for k, v in vals.items()})

        return {
            **{k: [round(float(np.mean(v)), 6)] for k, v in vals.items()},
            **{f"{k}_variance": [round(float(np.var(v)), 6)]
               for k, v in vals.items()},
        }


# ---------------------------------------------------------------------------
# FID
# ---------------------------------------------------------------------------

def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians. A singular product (fewer
    images than feature dimensions) makes sqrtm non-finite; it is then
    retried with ``eps`` added to both diagonals."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        covmean = linalg.sqrtm(sigma1.dot(sigma2))
        if not np.isfinite(covmean).all():
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("large imaginary component in cov sqrt")
        covmean = covmean.real

    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


class FID:
    """FID with a pluggable feature function: (B, H, W, 3) f32 in [0, 1]
    -> (B, D) features, a tensor on any device or an array
    (``eval/inception.py::make_inception_feature_fn``: pool3, D = 2048)."""

    def __init__(self, feature_fn: Callable, batch_size: int = 128):
        self.feature_fn = feature_fn
        self.batch_size = batch_size

    def activation_statistics(self, images: np.ndarray):
        # only n_batches * batch_size images are used, the ragged tail is
        # dropped, as the reference does
        batch_size = min(self.batch_size, len(images))
        n_used = (len(images) // batch_size) * batch_size
        feats = []
        for i in range(0, n_used, batch_size):
            f = self.feature_fn(images[i:i + batch_size])
            feats.append(f.cpu().numpy() if isinstance(f, torch.Tensor)
                         else np.asarray(f))
        feats = np.concatenate(feats, axis=0)
        mu = feats.mean(axis=0)
        sigma = np.cov(feats, rowvar=False)
        return mu, sigma

    def compute_statistics_of_path(self, path: str,
                                   img_size: Tuple[int, int]):
        npz_file = os.path.join(
            path, f"{img_size[0]}_{img_size[1]}_statistics.npz")
        if os.path.exists(npz_file):
            with np.load(npz_file) as f:
                return f["mu"][:], f["sigma"][:]
        files = get_image_list(path)
        images = np.stack([_load_resized(f, img_size) for f in files])
        mu, sigma = self.activation_statistics(images)
        np.savez(npz_file, mu=mu, sigma=sigma)
        return mu, sigma

    def calculate_from_disk(self, generated_path: str, gt_path: str,
                            img_size: Tuple[int, int]) -> float:
        m1, s1 = self.compute_statistics_of_path(gt_path, img_size)
        m2, s2 = self.compute_statistics_of_path(generated_path, img_size)
        return frechet_distance(m1, s1, m2, s2)


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise cosine similarity in f64 (the stage-1 batch test's
    score)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    num = np.sum(a * b, axis=-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return num / np.maximum(den, 1e-12)
