"""PiDiNet soft-edge detector (pixel-difference network, 'carv4') as an
``nn.Module``, NCHW (counterpart of ``pcdms_tpu/pose/detectors/pidi.py``).

controlnet_aux ``pidi/model.py``'s ``PiDiNet(60, carv4, dil=24, sa=True)``,
the ``table5_pidinet.pth`` model: 16 depthwise-separable blocks over 4
scales (60 / 120 / 240 / 240 channels) whose depthwise 3x3 convs are
pixel-difference convolutions, then per scale a compact dilated module
(CDCM, dilations 5 / 7 / 9 / 11 -> 24 channels), a compact spatial
attention (CSAM), a 1x1 reduction to an edge logit, a bilinear upsample to
the input grid, and a 1x1 fusion classifier; the output is the fused
sigmoid. BGR input in [0, 1].

The ``state_dict()`` holds the published kernels under the published names
(``init_block.weight``, ``block1_1.conv1.weight``, ``dilations.0.conv2_1``,
``attentions.0.conv1``, ``conv_reduces.0.conv``, ``classifier``).
``PiDiNet.fold`` turns each difference conv into the plain kernel it
equals, once, at load (the JAX package's ``pdc_transform``); the network
then runs as plain convolutions:
  * cd (central): the centre tap less the kernel's sum;
  * ad (angular): the kernel less its clockwise-rotated self;
  * rd (radial): the 3x3 ring scattered into a signed 5x5 kernel.
The 'carv4' layer order is [cd, ad, rd, cv] x 4.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pcdms_tpu_torch.pose.detectors.common import (
    as_image, hwc3, resize_to_64, safe_step, to_uint8_map,
)

PDCS = ["cd", "ad", "rd", "cv"] * 4        # 'carv4'
PLANES = [60, 120, 240, 240]
DIL = 24
DILATIONS = (5, 7, 9, 11)


def pdc_transform(w: torch.Tensor, op: str) -> torch.Tensor:
    """Fold a pixel-difference conv into the plain kernel it equals: w is
    (O, I, 3, 3); -> (O, I, 3, 3), or (O, I, 5, 5) for rd (padding 2).
    The cd sum is taken tap by tap in row-major order."""
    if op == "cv":
        return w
    if op == "cd":
        total = w[:, :, 0, 0]
        for i in range(3):
            for j in range(3):
                if i or j:
                    total = total + w[:, :, i, j]
        out = w.clone()
        out[:, :, 1, 1] = w[:, :, 1, 1] - total
        return out
    flat = w.reshape(*w.shape[:2], 9)
    if op == "ad":
        # clockwise neighbour rotation in row-major (3, 3) indexing
        return (flat - flat[:, :, [3, 0, 1, 6, 4, 2, 7, 8, 5]]).reshape(
            w.shape)
    if op == "rd":
        buf = w.new_zeros(*w.shape[:2], 25)
        ring = flat[:, :, 1:]
        buf[:, :, [0, 2, 4, 10, 14, 20, 22, 24]] = ring
        buf[:, :, [6, 7, 8, 11, 13, 16, 17, 18]] = -ring
        return buf.reshape(*w.shape[:2], 5, 5)
    raise ValueError(f"unknown pdc op: {op}")


class PDC(nn.Module):
    """The published pixel-difference conv's parameters (a 3x3 kernel, no
    bias); what it computes is its ``pdc_transform``."""

    def __init__(self, cin: int, cout: int, groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))


class PDCBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride2: bool):
        super().__init__()
        self.stride2 = stride2
        if stride2:
            self.shortcut = nn.Conv2d(cin, cout, 1)
        self.conv1 = PDC(cin, cin, groups=cin)
        self.conv2 = nn.Conv2d(cin, cout, 1, bias=False)

    def forward(self, x, kernel):
        if self.stride2:
            x = F.max_pool2d(x, 2, 2)
        y = F.conv2d(x, kernel, padding=(kernel.shape[-1] - 1) // 2,
                     groups=x.shape[1])
        y = self.conv2(F.relu(y))
        if self.stride2:
            x = self.shortcut(x)
        return y + x


class CDCM(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 1)
        for i, d in enumerate(DILATIONS, start=1):
            setattr(self, f"conv2_{i}", nn.Conv2d(cout, cout, 3, padding=d,
                                                  dilation=d, bias=False))

    def forward(self, x):
        x = self.conv1(F.relu(x))
        out = 0
        for i in range(1, 5):
            out = out + getattr(self, f"conv2_{i}")(x)
        return out


class CSAM(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, 4, 1)
        self.conv2 = nn.Conv2d(4, 1, 3, padding=1, bias=False)

    def forward(self, x):
        return x * torch.sigmoid(self.conv2(self.conv1(F.relu(x))))


class MapReduce(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, 1, 1)

    def forward(self, x):
        return self.conv(x)


def _block_names():
    """[(stage, name, pdc op, stride2)] of the 15 PDC blocks."""
    out, layer = [], 1
    for stage in range(4):
        for b in range(3 if stage == 0 else 4):
            out.append((stage, f"block{stage + 1}_{b + 1}", PDCS[layer],
                        stage > 0 and b == 0))
            layer += 1
    return out


class PiDiNet(nn.Module):
    """x: (N, 3, H, W) BGR in [0, 1] -> (N, 1, H, W) edge probability (the
    fused sigmoid, model.py forward's ``outputs[-1]``)."""

    def __init__(self):
        super().__init__()
        self.init_block = PDC(3, PLANES[0])
        cin = PLANES[0]
        for stage, name, _, stride2 in _block_names():
            cout = PLANES[stage]
            setattr(self, name, PDCBlock(cin, cout, stride2))
            cin = cout
        self.dilations = nn.ModuleList([CDCM(c, DIL) for c in PLANES])
        self.attentions = nn.ModuleList([CSAM(DIL) for _ in PLANES])
        self.conv_reduces = nn.ModuleList([MapReduce(DIL) for _ in PLANES])
        self.classifier = nn.Conv2d(4, 1, 1)

    @torch.no_grad()
    def fold(self) -> Dict[str, torch.Tensor]:
        """{"init_block" / block name: the plain kernel of its difference
        conv}; the detector makes it once, at load."""
        kernels = {"init_block": pdc_transform(self.init_block.weight,
                                               PDCS[0])}
        for _, name, op, _ in _block_names():
            kernels[name] = pdc_transform(getattr(self, name).conv1.weight,
                                          op)
        return kernels

    def forward(self, x, kernels: Dict[str, torch.Tensor] = None):
        kernels = self.fold() if kernels is None else kernels
        h, w = x.shape[2:]
        k0 = kernels["init_block"]
        f = F.conv2d(x, k0, padding=(k0.shape[-1] - 1) // 2)
        names = _block_names()
        logits = []
        for stage in range(4):
            for s, name, _, _ in names:
                if s == stage:
                    f = getattr(self, name)(f, kernels[name])
            y = self.attentions[stage](self.dilations[stage](f))
            e = self.conv_reduces[stage](y)
            logits.append(F.interpolate(e, (h, w), mode="bilinear",
                                        align_corners=False))
        return torch.sigmoid(self.classifier(torch.cat(logits, 1)))


class PidiNetDetector:
    """The reference's call protocol (pidi/__init__.py:38-84) on the port's
    network, on ``device`` (None: CUDA), in f32 with TF32 off: BGR / 255
    input, the fused sigmoid, optional threshold (``apply_filter``),
    ``safe_step`` and scribble post-passes."""

    def __init__(self, model: PiDiNet, device=None):
        from pcdms_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.kernels = self.model.fold()

    @classmethod
    def from_pretrained(cls, weights_path: str, device=None
                        ) -> "PidiNetDetector":
        """From ``table5_pidinet.pth`` (its ``module.`` prefix dropped;
        unpickled: trusted local files only)."""
        from pcdms_tpu_torch.pose.detectors.common import load_network
        return cls(load_network(PiDiNet(), weights_path), device)

    @torch.no_grad()
    def __call__(self, input_image, detect_resolution: int = 512,
                 image_resolution: int = 512, safe: bool = False,
                 scribble: bool = False,
                 apply_filter: bool = False) -> np.ndarray:
        from pcdms_tpu_torch.pose.detectors.hed import finish_edges
        from pcdms_tpu_torch.pose.dwpose import f32_forward
        img = hwc3(as_image(input_image, self.device))
        img = resize_to_64(img, detect_resolution)
        x = img.flip(-1).permute(2, 0, 1)[None].float() / 255.0
        with f32_forward():
            edge = self.model(x, self.kernels)[0, 0]
        if apply_filter:
            edge = (edge > 0.5).float()
        if safe:
            edge = safe_step(edge)
        return finish_edges(to_uint8_map(edge), img.shape[:2],
                            image_resolution, scribble)
