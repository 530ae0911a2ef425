"""LeReS relative-depth detector (ResNeXt101-32x8d + FFM decoder) as an
``nn.Module``, NCHW (counterpart of ``pcdms_tpu/pose/detectors/leres.py``).

controlnet-aux ``leres``'s ``RelDepthModel(backbone='resnext101')`` under
the published key names of ``res101.pth``'s ``depth_model`` dict
(``depth_model.encoder_modules.*``: torchvision's ResNeXt101-32x8d;
``depth_model.decoder_modules.*``: the FTB / FFM / AO decoder with
align-corners 2x upsampling). ``fold`` folds every BatchNorm into its conv,
as the JAX converter does. The network takes raw 0-255 **BGR** and
normalises it with ImageNet's RGB statistics, the reference's channel
quirk, kept. ``LeresDetector`` runs the 16-bit normalisation and its
uint8 operations on the device, and the LeReS++ boost
(``leres_boost.py``) when the merge network is given.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pcdms_tpu_torch.pose import imgproc
from pcdms_tpu_torch.pose.detectors.common import (
    as_image, fold_bn_pairs, hwc3, resize_to_64, sequential_bn_pairs,
    shape_to_64,
)
from pcdms_tpu_torch.pose.detectors.midas import up2_align_corners

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
LAYERS = (3, 4, 23, 3)
GROUPS = 32
WIDTH_PER_GROUP = 8


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, downsample):
        super().__init__()
        width = planes * WIDTH_PER_GROUP * GROUPS // 64
        cout = planes * 4
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=GROUPS,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, cout, 1, stride,
                                                   bias=False),
                                         nn.BatchNorm2d(cout))
                           if downsample else None)

    def forward(self, x):
        sc = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        return F.relu(self.bn3(self.conv3(h)) + sc)


class ResNeXt101(nn.Module):
    """-> the four stage features [1/4 256, 1/8 512, 1/16 1024, 1/32
    2048]."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for li, (depth, planes) in enumerate(zip(LAYERS, (64, 128, 256, 512)),
                                             1):
            blocks = []
            for bi in range(depth):
                stride = 2 if (bi == 0 and li > 1) else 1
                blocks.append(Bottleneck(cin, planes, stride, bi == 0))
                cin = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*blocks))

    def forward(self, x) -> List[torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, 2, 1)
        outs = []
        for li in range(1, 5):
            h = getattr(self, f"layer{li}")(h)
            outs.append(h)
        return outs


class FTB(nn.Module):
    """Feature-transfer block: 3x3 conv, then a relu-conv-bn-relu-conv
    residual branch, add, relu."""

    def __init__(self, cin, mid):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, mid, 3, padding=1)
        self.conv_branch = nn.Sequential(
            nn.ReLU(), nn.Conv2d(mid, mid, 3, padding=1), nn.BatchNorm2d(mid),
            nn.ReLU(), nn.Conv2d(mid, mid, 3, padding=1))

    def forward(self, x):
        x = self.conv1(x)
        return F.relu(x + self.conv_branch(x))


class FFM(nn.Module):
    def __init__(self, cin, mid, cout):
        super().__init__()
        self.ftb1 = FTB(cin, mid)
        self.ftb2 = FTB(mid, cout)

    def forward(self, low, high):
        return up2_align_corners(self.ftb2(self.ftb1(low) + high))


class AO(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.adapt_conv = nn.Sequential(
            nn.Conv2d(cin, cin // 2, 3, padding=1), nn.BatchNorm2d(cin // 2),
            nn.ReLU(), nn.Conv2d(cin // 2, cout, 3, padding=1))

    def forward(self, x):
        return up2_align_corners(self.adapt_conv(x))


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = FTB(2048, 512)
        self.conv1 = nn.Conv2d(512, 256, 3, padding=1)
        self.ffm2 = FFM(1024, 256, 256)
        self.ffm1 = FFM(512, 256, 256)
        self.ffm0 = FFM(256, 256, 256)
        self.outconv = AO(256, 1)

    def forward(self, feats):
        x = up2_align_corners(self.conv1(self.conv(feats[3])))
        x = self.ffm2(feats[2], x)
        x = self.ffm1(feats[1], x)
        x = self.ffm0(feats[0], x)
        return self.outconv(x)


class DepthModel(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder_modules = ResNeXt101()
        self.decoder_modules = Decoder()


class RelDepthModel(nn.Module):
    """x: (B, 3, H, W) raw 0-255 BGR, H and W multiples of 32 -> (B, H, W)
    relative depth."""

    def __init__(self):
        super().__init__()
        self.depth_model = DepthModel()

    def fold(self) -> "RelDepthModel":
        """Every BatchNorm folded into its conv (in place; -> self)."""
        enc = "depth_model.encoder_modules"
        pairs = [(f"{enc}.conv1", f"{enc}.bn1")]
        for name, m in self.named_modules():
            if isinstance(m, Bottleneck):
                pairs += [(f"{name}.conv{i}", f"{name}.bn{i}")
                          for i in (1, 2, 3)]
        return fold_bn_pairs(self, pairs + sequential_bn_pairs(self))

    def forward(self, x):
        mean = torch.from_numpy(MEAN).to(x)[:, None, None]
        std = torch.from_numpy(STD).to(x)[:, None, None]
        x = (x / 255.0 - mean) / std
        dm = self.depth_model
        return dm.decoder_modules(dm.encoder_modules(x))[:, 0]


class LeresDetector:
    """leres/__init__.py:59-118's call protocol on the port's networks, on
    ``device`` (None: CUDA), in f32 with TF32 off."""

    def __init__(self, model: RelDepthModel, pix2pix=None, device=None):
        from pcdms_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.model = model.fold().to(self.device).eval()
        self.pix2pix = (None if pix2pix is None
                        else pix2pix.to(self.device).eval())

    @classmethod
    def from_pretrained(cls, weights_path: str, pix2pix_weights: str = None,
                        device=None):
        """From ``res101.pth`` (its ``depth_model`` dict, ``module.`` taken
        off) and, for the boost, ``latest_net_G.pth`` (unpickled: trusted
        local files only)."""
        from pcdms_tpu_torch.pose.detectors.common import empty, load_network
        from pcdms_tpu_torch.pose.detectors.leres_boost import pix2pix4depth
        p2p = (None if pix2pix_weights is None
               else load_network(empty(pix2pix4depth), pix2pix_weights))
        return cls(load_network(empty(RelDepthModel), weights_path), p2p,
                   device)

    def _forward(self, bgr: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) f32 BGR -> (H, W) depth."""
        from pcdms_tpu_torch.pose.dwpose import f32_forward
        with f32_forward():
            return self.model(bgr.permute(2, 0, 1)[None])[0]

    def _estimate(self, rgb: torch.Tensor, w: int, h: int) -> torch.Tensor:
        """estimateleres on an (H, W, 3) RGB tensor: the BGR flip, an f32
        bilinear resize to (w, h), the network, the bicubic way back."""
        bgr = rgb.flip(2).float().contiguous()
        depth = self._forward(imgproc.resize(bgr, (w, h), "linear"))
        return imgproc.resize(depth, (rgb.shape[1], rgb.shape[0]), "cubic")

    @torch.no_grad()
    def __call__(self, input_image, thr_a: float = 0, thr_b: float = 0,
                 boost: bool = False, detect_resolution: int = 512,
                 image_resolution: int = 512) -> np.ndarray:
        if boost and self.pix2pix is None:
            raise NotImplementedError(
                "LeReS boost mode needs the pix2pix merge network: pass "
                "pix2pix_weights=... (latest_net_G.pth) to "
                "from_pretrained.")
        img = hwc3(as_image(input_image, self.device))
        img = resize_to_64(img, detect_resolution)
        if boost:
            from pcdms_tpu_torch.pose.detectors.leres_boost import (
                estimateboost,
            )
            depth = estimateboost(img, self._estimate, self.pix2pix,
                                  max_res=max(img.shape[:2]))
        else:
            depth = self._forward(img.flip(2).float())   # reference quirk
        depth_image = normalize_16bit(depth)
        if thr_a != 0:
            depth_image = imgproc.threshold_tozero(depth_image,
                                                   thr_a / 100 * 255)
        depth_image = imgproc.bitwise_not(depth_image)
        if thr_b != 0:
            depth_image = imgproc.threshold_tozero(depth_image,
                                                   thr_b / 100 * 255)
        detected = hwc3(depth_image)
        out_hw = shape_to_64(*img.shape[:2], image_resolution)
        return imgproc.resize(detected, (out_hw[1], out_hw[0]),
                              "linear").cpu().numpy()


def normalize_16bit(depth: torch.Tensor) -> torch.Tensor:
    """leres/__init__.py's 16-bit step: the f32 map min-max scaled to
    [0, 65535] (zeros when flat), truncated to uint16, then
    ``convertScaleAbs`` to uint8 by 255 / 65535."""
    dmin, dmax = depth.min(), depth.max()
    if float(dmax - dmin) > np.finfo(np.float32).eps:
        out = 65535.0 * (depth - dmin) / (dmax - dmin)
    else:
        out = torch.zeros_like(depth)
    # uint16 truncation: exact in int32 for these values
    return imgproc.convert_scale_abs(out.to(torch.int32), 255.0 / 65535.0)
