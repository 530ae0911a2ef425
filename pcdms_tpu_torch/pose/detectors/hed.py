"""HED soft-edge detector (ControlNet's Apache-2 HED) as an ``nn.Module``,
NCHW (counterpart of ``pcdms_tpu/pose/detectors/hed.py``).

controlnet_aux ``hed/__init__.py``'s ``ControlNetHED_Apache2``: a learned
per-channel input shift (``norm``), 5 VGG-style stages (2 / 2 / 3 / 3 / 3
convs of 64 / 128 / 256 / 512 / 512 channels, a 2x2 max pool before
stages 2-5) each with a 1x1 projection to one edge logit. The
``state_dict()`` has the published names (``norm``, ``block1.convs.0``,
``block1.projection``, ...), so ``ControlNetHED.pth`` loads as it is. RGB
input in [0, 255].

``HEDdetector`` keeps the reference's protocol (hed/__init__.py:85-129):
the five logit maps resized to the input grid (INTER_LINEAR on f32, on the
card), averaged and squashed by a sigmoid in f64 on the host, optionally
quantised (``safe``), resized to the output grid, optionally thinned into
a scribble.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pcdms_tpu_torch.pose import imgproc
from pcdms_tpu_torch.pose.detectors.common import (
    as_image, hwc3, resize_to_64, safe_step, scribble_postprocess,
    shape_to_64, to_uint8_map,
)

# (n_convs, channels) per stage
STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


class DoubleConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n: int):
        super().__init__()
        self.convs = nn.Sequential(*[nn.Conv2d(cin if i == 0 else cout,
                                               cout, 3, 1, 1)
                                     for i in range(n)])
        self.projection = nn.Conv2d(cout, 1, 1)

    def forward(self, x, down_sampling: bool = False):
        h = F.max_pool2d(x, 2, 2) if down_sampling else x
        for conv in self.convs:
            h = F.relu(conv(h))
        return h, self.projection(h)


class ControlNetHED(nn.Module):
    """x: (N, 3, H, W) RGB in [0, 255] -> the 5 edge-logit maps,
    (N, 1, H / 2^s, W / 2^s) for s = 0..4."""

    def __init__(self):
        super().__init__()
        self.norm = nn.Parameter(torch.zeros(1, 3, 1, 1))
        cin = 3
        for si, (n, ch) in enumerate(STAGES, start=1):
            setattr(self, f"block{si}", DoubleConvBlock(cin, ch, n))
            cin = ch

    def forward(self, x):
        h = x - self.norm
        projections = []
        for si in range(1, 6):
            h, p = getattr(self, f"block{si}")(h, down_sampling=si > 1)
            projections.append(p)
        return projections


class HEDdetector:
    """The reference's call protocol on the port's network, on ``device``
    (None: CUDA), in f32 with TF32 off."""

    def __init__(self, model: nn.Module, device=None):
        from pcdms_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_pretrained(cls, weights_path: str, device=None) -> "HEDdetector":
        """From ``ControlNetHED.pth`` (unpickled: trusted local files)."""
        from pcdms_tpu_torch.pose.detectors.common import load_network
        return cls(load_network(ControlNetHED(), weights_path), device)

    @torch.no_grad()
    def edges(self, img: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) uint8 RGB on the device -> the (H, W) f64 edge
        probability on the device: the five maps resized to (H, W), their
        mean in f64 (summed in order, as numpy's mean over five values),
        the sigmoid."""
        from pcdms_tpu_torch.pose.dwpose import f32_forward
        h, w = img.shape[:2]
        with f32_forward():
            maps = self.model(img.permute(2, 0, 1)[None].float())
        total = None
        for e in maps:
            m = imgproc.resize(e[0, 0], (w, h), "linear").double()
            total = m if total is None else total + m
        return 1.0 / (1.0 + torch.exp(-(total / len(maps))))

    def __call__(self, input_image, detect_resolution: int = 512,
                 image_resolution: int = 512, safe: bool = False,
                 scribble: bool = False) -> np.ndarray:
        img = hwc3(as_image(input_image, self.device))
        img = resize_to_64(img, detect_resolution)
        edge = self.edges(img)
        if safe:
            edge = safe_step(edge)
        return finish_edges(to_uint8_map(edge), img.shape[:2],
                            image_resolution, scribble)


def finish_edges(detected: torch.Tensor, hw, image_resolution: int,
                 scribble: bool) -> np.ndarray:
    """The soft-edge families' tail: INTER_LINEAR to the output grid, then
    the scribble post-pass if asked -> (H, W, 3) uint8 numpy."""
    out_hw = shape_to_64(*hw, image_resolution)
    detected = imgproc.resize_linear(detected, (out_hw[1], out_hw[0]))
    if scribble:
        detected = scribble_postprocess(detected)
    return detected.cpu().numpy()
