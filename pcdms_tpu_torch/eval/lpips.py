"""LPIPS with AlexNet features (counterpart of ``pcdms_tpu/eval/lpips.py``),
``lpips.LPIPS(net='alex')`` of the reference's ``metrics.py``.

AlexNet's five convs with a ReLU tap after each, max-pool after taps 0
and 1; the input shifted and scaled by LPIPS's constants; each tap unit-
normalised over channels (eps 1e-10), the squared differences weighted by
the calibrated 1x1 ``lin`` heads, averaged over space and summed over the
taps. The weights are the ``lpips`` package's (``net.slice{i}.{j}.*`` or
``net.features.{j}.*``, and ``lin{i}.model.1.weight``), from a local file
through ``compat/load.py``. The forward runs in f32 with TF32 off.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pcdms_tpu_torch.eval import f32_convs

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# AlexNet's convs: (cin, cout, kernel, stride, pad); max-pool after taps 0, 1
ALEX = [(3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
        (384, 256, 3, 1, 1), (256, 256, 3, 1, 1)]
# each conv's index in torchvision's ``features`` and its lpips slice
FEATURE_INDEX = [0, 3, 6, 8, 10]
SLICE_INDEX = [1, 2, 3, 4, 5]


class LPIPS(nn.Module):
    """``convs.{i}`` the AlexNet convs, ``lins.{i}`` the (C,) lin heads."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, k, stride=s, padding=p)
            for cin, cout, k, s, p in ALEX)
        self.lins = nn.ParameterList(
            nn.Parameter(torch.zeros(cout)) for _, cout, _, _, _ in ALEX)
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def features(self, x):
        """x: (B, 3, H, W), already shifted and scaled -> the 5 taps."""
        feats = []
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            feats.append(x)
            if i in (0, 1):
                x = F.max_pool2d(x, 3, 2)
        return feats

    def forward(self, img1, img2):
        """img1 / img2: (B, H, W, 3) -> (B,) LPIPS distances. The network
        expects [-1, 1]; the protocol feeds [0, 1] as they are."""
        x1 = (img1.permute(0, 3, 1, 2).float() - self.shift) / self.scale
        x2 = (img2.permute(0, 3, 1, 2).float() - self.shift) / self.scale
        with f32_convs():
            f1, f2 = self.features(x1), self.features(x2)
        total = 0.0
        for a, b, w in zip(f1, f2, self.lins):
            a = a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True))
                     + 1e-10)
            b = b / (torch.sqrt(torch.sum(b * b, dim=1, keepdim=True))
                     + 1e-10)
            d = torch.sum((a - b) ** 2 * w.view(1, -1, 1, 1), dim=1)
            total = total + d.mean(dim=(1, 2))
        return total


def convert_lpips(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An ``lpips`` (alex) state dict in either naming -> ``LPIPS``'s."""
    out = {}
    for i, (slice_idx, feat_idx) in enumerate(zip(SLICE_INDEX,
                                                  FEATURE_INDEX)):
        for name in (f"net.slice{slice_idx}.{feat_idx}",
                     f"net.features.{feat_idx}"):
            if f"{name}.weight" in sd:
                out[f"convs.{i}.weight"] = sd[f"{name}.weight"].float()
                out[f"convs.{i}.bias"] = sd[f"{name}.bias"].float()
                break
        else:
            raise KeyError(f"conv {feat_idx} not found in lpips state dict")
        for name in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if name in sd:
                # (1, C, 1, 1) non-negative 1x1 conv -> (C,)
                out[f"lins.{i}"] = sd[name].float().reshape(-1)
                break
        else:
            raise KeyError(f"lin{i} not found in lpips state dict")
    return out


def load_lpips(weights_path: str, device=None) -> LPIPS:
    """LPIPS-Alex from a local torch weight file, on ``device`` (None:
    CUDA), in eval mode."""
    from pcdms_tpu_torch.compat.load import load_state_dict
    from pcdms_tpu_torch.utils.device import resolve_device
    model = LPIPS()
    model.load_state_dict(convert_lpips(load_state_dict(weights_path)))
    return model.to(resolve_device(device)).eval()


def lpips_from_disk(weights_path: str, files_1, files_2, img_size,
                    batch_size: int = 64, device=None) -> float:
    """Mean LPIPS over paired file lists at ``img_size`` = (W, H), in
    batches of ``batch_size``; the ragged tail is dropped, as the
    reference does. The [0, 1] images go in without a rescale to [-1, 1]
    (the reference calls lpips with its default ``normalize=False``)."""
    from pcdms_tpu_torch.eval.metrics import _load_resized

    model = load_lpips(weights_path, device)
    dev = next(model.parameters()).device
    results = []
    n = len(files_1)
    batch_size = min(batch_size, n)
    with torch.no_grad():
        for i in range(0, n - n % batch_size, batch_size):
            a, b = (torch.from_numpy(np.stack([
                _load_resized(f, img_size) for f in files[i:i + batch_size]
            ])).to(dev) for files in (files_1, files_2))
            results.append(model(a, b).cpu().numpy())
    return float(np.mean(np.concatenate(results)))
