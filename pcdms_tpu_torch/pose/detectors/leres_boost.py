"""LeReS++ boost: the pix2pix depth-merge network and the multi-resolution
boosting protocol (counterpart of
``pcdms_tpu/pose/detectors/leres_boost.py``).

  * the merge network is pix2pix's ``UnetGenerator(2, 1, 10, 64,
    norm='none')`` (``lineart_anime.UnetGenerator`` with ``norm=False``),
    under ``latest_net_G.pth``'s key names;
  * ``double``: LeReS at the receptive-field size (448) and at a second
    size, both min-max normalised to [-1, 1] and merged at 1024 x 1024;
  * ``estimateboost``: the gradient-driven resolution search
    (``calculateprocessingres``), the patch selection over the gradient's
    integral image (``generatepatchs``), each patch's double estimate fitted
    to the base estimate by a degree-1 least-squares fit and blended in
    under a Gaussian mask.

The image operations, the networks and the fits run on the image's device;
the decisions (the resolution, the patch set, the loop's exits) are taken
on the host from the same values, as the JAX package takes them. Two cv2
calls of the reference pass their flag as ``dst`` (``cv2.resize(grad, (d,
d), cv2.INTER_AREA)`` and ``cv2.resize(..., cv2.INTER_NEAREST)``), so cv2
runs its default bilinear there; this module does what cv2 does.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from pcdms_tpu_torch.pose import imgproc
from pcdms_tpu_torch.pose.detectors.lineart_anime import UnetGenerator

PIX2PIX_SIZE = 1024
RECEPTIVE = 448                     # LeReS receptive field
WHOLE_SIZE_THRESHOLD = 3000
# (outer_nc, inner_nc) outermost -> innermost, UnetGenerator(2, 1, 10, 64)
LEVELS = [(1, 64), (64, 128), (128, 256), (256, 512)] + [(512, 512)] * 6
_GRAY = (0.2989, 0.587, 0.114)


def pix2pix4depth(levels=None) -> UnetGenerator:
    """The merge network: bias-free convs, identities in the norm slots, a
    biased outermost upconv."""
    return UnetGenerator(2, LEVELS if levels is None else levels, norm=False)


def merge_depths(net: UnetGenerator, outer: torch.Tensor,
                 inner: torch.Tensor) -> torch.Tensor:
    """Pix2Pix4DepthModel.set_input + test: each (S, S) estimate min-max
    normalised to [-1, 1], merged -> the [0, 1] (S, S) f32 map."""
    from pcdms_tpu_torch.pose.dwpose import f32_forward

    def norm(x):
        x = x.float()
        lo = x.min()
        x = (x - lo) / max(float(x.max() - lo), 1e-12)
        return x * 2.0 - 1.0
    stacked = torch.stack([norm(outer), norm(inner)])[None]
    with f32_forward():
        out = net(stacked)[0, 0]
    return (out + 1.0) / 2.0


def generatemask(size: Tuple[int, int], device=None) -> torch.Tensor:
    """The Gaussian blend mask (depthmap.py:52-61): ones inside a 15 %
    margin, blurred with sigma size / 16 over ``2 ceil(2 sigma) + 1`` taps,
    min-max normalised, f32."""
    h, w = size
    mask = torch.zeros(size, dtype=torch.float32, device=device)
    mask[int(0.15 * h):h - int(0.15 * h), int(0.15 * w):w - int(0.15 * w)] = 1
    sigma = int(h / 16)
    mask = imgproc.gaussian_blur(mask, sigma, int(2 * np.ceil(2 * sigma) + 1))
    lo = mask.min()
    return (mask - lo) / (mask.max() - lo)


def resizewithpool(img: np.ndarray, size: int) -> np.ndarray:
    """skimage's ``block_reduce(img, (n, n), np.max)`` with ``n =
    floor(H / size)``: non-overlapping max pooling, the image padded to a
    block multiple with -inf (depthmap.py:63-68)."""
    n = int(np.floor(img.shape[0] / size))
    h, w = img.shape
    ph, pw = (-h) % n, (-w) % n
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw)), mode="constant",
                     constant_values=-np.inf)
    hh, ww = img.shape
    return img.reshape(hh // n, n, ww // n, n).max(axis=(1, 3))


def _gradient(img: torch.Tensor) -> torch.Tensor:
    """|Sobel_y| + |Sobel_x| of the f64 gray image of (H, W, 3) ``img``."""
    gray = img[..., :3].double() @ torch.tensor(_GRAY, dtype=torch.float64,
                                                device=img.device)
    return (imgproc.sobel(gray, 0, 1).abs() + imgproc.sobel(gray, 1, 0).abs())


def calculateprocessingres(img: torch.Tensor, basesize: int,
                           confidence: float = 0.1, scale_threshold: int = 3,
                           whole_size_threshold: int = WHOLE_SIZE_THRESHOLD
                           ) -> Tuple[int, float]:
    """The R-x resolution search (depthmap.py:74-130) -> (the whole
    image's processing size, the share of the dilated gradient mask). The
    gradient on the image's device; the search on the host."""
    speed_scale = 32
    image_dim = int(min(img.shape[:2]))
    grad = _gradient(img).cpu()
    # cv2.resize(grad, (d, d), cv2.INTER_AREA): the flag lands in ``dst``,
    # so cv2 runs INTER_LINEAR
    grad = imgproc.resize(grad, (image_dim, image_dim), "linear").numpy()
    middle = grad.min() + 0.4 * (grad.max() - grad.min())
    grad = np.where(grad < middle, 0.0, 1.0)

    kernel = np.ones((int(basesize / speed_scale),) * 2, float)
    kernel2 = np.ones((int(basesize / (4 * speed_scale)),) * 2, float)
    threshold = min(whole_size_threshold,
                    scale_threshold * max(img.shape[:2]))
    outputsize_scale = basesize / speed_scale
    grad_resized = torch.from_numpy(grad)
    for p_size in range(int(basesize / speed_scale),
                        int(threshold / speed_scale),
                        int(basesize / (2 * speed_scale))):
        pooled = torch.from_numpy(resizewithpool(grad, p_size))
        # cv2.resize(..., cv2.INTER_NEAREST): INTER_LINEAR, as above
        grad_resized = imgproc.resize(pooled, (p_size, p_size), "linear")
        grad_resized = (grad_resized >= 0.5).float()
        dilated = imgproc.dilate(grad_resized, kernel)
        if (1 - dilated.numpy()).mean() > confidence:
            break
        outputsize_scale = p_size
    grad_region = imgproc.dilate(grad_resized, kernel2).numpy()
    return int(outputsize_scale * speed_scale), float(grad_region.mean())


def _gf_from_integral(integral: np.ndarray, rect) -> float:
    x1, x2 = rect[1], rect[1] + rect[3]
    y1, y2 = rect[0], rect[0] + rect[2]
    return (integral[x2, y2] - integral[x1, y2] - integral[x2, y1]
            + integral[x1, y1])


def generatepatchs(img: torch.Tensor, base_size: int,
                   factor: float) -> List:
    """The gradient-driven patch selection (depthmap.py:178-268) -> [{"rect":
    [x, y, w, h], "size": w}], largest first. The gradient on the image's
    device; its integral image and the search on the host."""
    whole_grad = _gradient(img).cpu().numpy()
    threshold = whole_grad[whole_grad > 0].mean()
    whole_grad[whole_grad < threshold] = 0
    gf = whole_grad.sum() / whole_grad.size
    integral = imgproc.integral(torch.from_numpy(whole_grad)).numpy()

    blsize = int(round(base_size / 2))
    stride = int(round(blsize * 0.75))
    bounds = []
    for k in range(blsize, img.shape[1] - blsize, stride):
        for j in range(blsize, img.shape[0] - blsize, stride):
            bounds.append([k - blsize, j - blsize, 2 * blsize, 2 * blsize])

    height, width = integral.shape
    search_step = int(32 / factor)
    selected = []
    for bbox in bounds:
        cgf = _gf_from_integral(integral, bbox) / (bbox[2] * bbox[3])
        if cgf < gf:
            continue
        bbox = list(bbox)
        while True:
            test = [bbox[0] - int(search_step / 2),
                    bbox[1] - int(search_step / 2),
                    bbox[2] + search_step, bbox[3] + search_step]
            if (test[0] < 0 or test[1] < 0 or test[1] + test[3] >= height
                    or test[0] + test[2] >= width):
                break
            if _gf_from_integral(integral, test) / (test[2] * test[3]) < gf:
                break
            bbox = test
        selected.append({"rect": bbox, "size": bbox[2]})
    selected.sort(key=lambda p: p["size"], reverse=True)
    return selected


def _fit_linear(mapped: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """The degree-1 least-squares fit of ``mapped`` to ``base`` in f64 (the
    JAX package's closed form: a variance floor of 1e-12, under which the
    slope is 0) -> the fitted f64 map."""
    m = mapped.reshape(-1).double()
    b = base.reshape(-1).double()
    var = float(m.var(unbiased=False))
    slope = (float(((m - m.mean()) * (b - b.mean())).mean()) / var
             if var > 1e-12 else 0.0)
    intercept = b.mean() - slope * m.mean()
    return (slope * m + intercept).reshape(mapped.shape)


def estimateboost(img: torch.Tensor,
                  single_estimate: Callable[[torch.Tensor, int, int],
                                            torch.Tensor],
                  net: UnetGenerator, max_res: int = 512,
                  merge: Callable = None, log: list = None) -> torch.Tensor:
    """The BoostingMonocularDepth merge (depthmap.py:380-548) on an (H, W,
    3) uint8 RGB tensor: ``single_estimate(img, w, h)`` -> (H, W) depth (the
    LeReS path); ``net`` the merge network (``merge(net, outer, inner)``
    replaces ``merge_depths`` where given). -> (H, W) f32 depth. ``log``,
    where given, gets {"whole_size", "patch_scale", "factor", "patches":
    [(rect on ``img_big``, rect on the image)]}."""
    merge = merge_depths if merge is None else merge
    size = PIX2PIX_SIZE

    def double(im, size1, size2):
        e1 = imgproc.resize(single_estimate(im, size1, size1), (size, size),
                            "cubic")
        e2 = imgproc.resize(single_estimate(im, size2, size2), (size, size),
                            "cubic")
        merged = merge(net, e1, e2)
        lo = merged.min()
        return (merged - lo) / max(float(merged.max() - lo), 1e-12)

    input_res = img.shape
    whole_opt_size, patch_scale = calculateprocessingres(
        img, RECEPTIVE, 0.2, 3, WHOLE_SIZE_THRESHOLD)
    whole_estimate = double(img, RECEPTIVE, whole_opt_size)
    factor = max(min(1.0, 4 * patch_scale * whole_opt_size
                     / WHOLE_SIZE_THRESHOLD), 0.2)
    info = {"whole_size": whole_opt_size, "patch_scale": patch_scale,
            "factor": factor, "patches": []}
    if log is not None:
        log.append(info)
    if max_res < whole_opt_size:
        return imgproc.resize(whole_estimate, (input_res[1], input_res[0]),
                              "cubic")

    if img.shape[0] > img.shape[1]:
        a = 2 * whole_opt_size
        b = round(2 * whole_opt_size * img.shape[1] / img.shape[0])
    else:
        a = round(2 * whole_opt_size * img.shape[0] / img.shape[1])
        b = 2 * whole_opt_size
    a, b = int(round(a / factor)), int(round(b / factor))
    img_big = imgproc.resize(img, (b, a), "cubic")
    patchset = generatepatchs(img_big, RECEPTIVE * 2, factor)

    mergein_scale = input_res[0] / img_big.shape[0]
    rgb_scaled = imgproc.resize(
        img_big, (round(img_big.shape[1] * mergein_scale),
                  round(img_big.shape[0] * mergein_scale)), "cubic")
    updated = imgproc.resize(whole_estimate,
                             (rgb_scaled.shape[1], rgb_scaled.shape[0]),
                             "cubic")
    base = updated.clone()
    mask_org = generatemask((3000, 3000), img.device)
    mask = mask_org

    for patch in patchset:
        rect = np.round(np.array(patch["rect"]) * mergein_scale).astype(int)
        w1, h1 = rect[0], rect[1]
        w2, h2 = w1 + rect[2], h1 + rect[3]
        patch_rgb = rgb_scaled[h1:h2, w1:w2]
        patch_base = base[h1:h2, w1:w2]
        if patch_rgb.numel() == 0:
            continue
        info["patches"].append((list(patch["rect"]), rect.tolist()))
        org_size = tuple(patch_base.shape)
        patch_est = double(patch_rgb, RECEPTIVE, RECEPTIVE * 2)
        patch_est = imgproc.resize(patch_est, (size, size), "cubic")
        base_up = imgproc.resize(patch_base.contiguous(), (size, size),
                                 "cubic")
        merged = _fit_linear(merge(net, base_up, patch_est), base_up)
        merged = imgproc.resize(merged, (org_size[1], org_size[0]), "cubic")
        if tuple(mask.shape) != org_size:
            mask = imgproc.resize(mask_org, (org_size[1], org_size[0]),
                                  "linear")
        # numpy: f32 * f32 + f64 * f32 in f64, stored back in the f32 map
        updated[h1:h2, w1:w2] = (
            (updated[h1:h2, w1:w2] * (1 - mask)).double()
            + merged * mask.double()).float()

    return imgproc.resize(updated, (input_res[1], input_res[0]), "cubic")
