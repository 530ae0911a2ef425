"""LineArt-Anime detector (pix2pix-style 8-level U-Net generator) as an
``nn.Module``, NCHW (counterpart of
``pcdms_tpu/pose/detectors/lineart_anime.py``).

controlnet-aux ``lineart_anime``'s ``UnetGenerator(3, 1, 8, 64)`` with
InstanceNorm without affine parameters: eight k4 / s2 / p1 downsamples
(3 -> 64 -> 128 -> 256 -> 512 x 5), symmetric transposed-conv upsamples
with skip concatenation, LeakyReLU(0.2) down, ReLU up, a tanh head. The
levels nest as published (``model.model.1.model.3.model...``), so
``netG.pth`` loads as it is. ``UnetGenerator`` with ``norm=False`` is also
the LeReS++ merge network (``leres_boost.py``): bias-free convs, identities
in the norm slots, a biased outermost upconv.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from pcdms_tpu_torch.pose import imgproc
from pcdms_tpu_torch.pose.detectors.common import (
    as_image, hwc3, resize_to_64, shape_to_64,
)

# (outer_nc, inner_nc) outermost -> innermost for UnetGenerator(3, 1, 8, 64)
LEVELS: List[Tuple[int, int]] = [(1, 64), (64, 128), (128, 256), (256, 512),
                                 (512, 512), (512, 512), (512, 512),
                                 (512, 512)]


class UnetSkipBlock(nn.Module):
    """pix2pix ``UnetSkipConnectionBlock``: ``model`` is the published
    Sequential (outermost [down, sub, relu, up, tanh]; innermost [lrelu,
    down, relu, up, norm]; middle [lrelu, down, norm, sub, relu, up,
    norm]); a level other than the outermost concatenates its input."""

    def __init__(self, outer: int, inner: int, in_ch: int, sub=None,
                 outermost: bool = False, norm: bool = True):
        super().__init__()
        self.outermost = outermost

        def nrm(c):
            return nn.InstanceNorm2d(c) if norm else nn.Identity()
        down = nn.Conv2d(in_ch, inner, 4, 2, 1, bias=norm)
        if outermost:
            layers = [down, sub, nn.ReLU(),
                      nn.ConvTranspose2d(inner * 2, outer, 4, 2, 1),
                      nn.Tanh()]
        elif sub is None:
            layers = [nn.LeakyReLU(0.2), down, nn.ReLU(),
                      nn.ConvTranspose2d(inner, outer, 4, 2, 1, bias=norm),
                      nrm(outer)]
        else:
            layers = [nn.LeakyReLU(0.2), down, nrm(inner), sub, nn.ReLU(),
                      nn.ConvTranspose2d(inner * 2, outer, 4, 2, 1,
                                         bias=norm), nrm(outer)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


class UnetGenerator(nn.Module):
    """x: (N, input_nc, H, W) in [-1, 1], H and W multiples of
    2^len(levels) -> (N, 1, H, W) in [-1, 1]."""

    def __init__(self, input_nc: int = 3,
                 levels: Sequence[Tuple[int, int]] = tuple(LEVELS),
                 norm: bool = True):
        super().__init__()
        block = None
        for i in range(len(levels) - 1, -1, -1):
            outer, inner = levels[i]
            block = UnetSkipBlock(outer, inner, input_nc if i == 0 else outer,
                                  block, outermost=i == 0, norm=norm)
        self.model = block

    def forward(self, x):
        return self.model(x)


class LineartAnimeDetector:
    """The reference's call protocol (lineart_anime/__init__.py:145-188) on
    the port's network, on ``device`` (None: CUDA), in f32 with TF32
    off."""

    def __init__(self, model: UnetGenerator, device=None):
        from pcdms_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_pretrained(cls, weights_path: str, device=None):
        """From ``netG.pth`` (unpickled: trusted local files only)."""
        from pcdms_tpu_torch.pose.detectors.common import empty, load_network
        return cls(load_network(empty(UnetGenerator), weights_path), device)

    @torch.no_grad()
    def __call__(self, input_image, detect_resolution: int = 512,
                 image_resolution: int = 512) -> np.ndarray:
        from pcdms_tpu_torch.pose.dwpose import f32_forward
        img = hwc3(as_image(input_image, self.device))
        img = resize_to_64(img, detect_resolution)
        h, w = img.shape[:2]
        hn = 256 * int(np.ceil(h / 256.0))
        wn = 256 * int(np.ceil(w / 256.0))
        feed = imgproc.resize(img, (wn, hn), "cubic")
        x = feed.permute(2, 0, 1)[None].float() / 127.5 - 1.0
        with f32_forward():
            line = self.model(x)[0, 0] * 127.5 + 127.5
        line = imgproc.resize(line, (w, h), "cubic")
        detected = hwc3(line.clamp(0, 255).to(torch.uint8))
        out_hw = shape_to_64(h, w, image_resolution)
        detected = imgproc.resize(detected, (out_hw[1], out_hw[0]), "linear")
        return (255 - detected).cpu().numpy()
