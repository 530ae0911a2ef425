"""M-LSD line-segment detector (``MobileV2_MLSD_Large``) as an
``nn.Module``, NCHW (counterpart of ``pcdms_tpu/pose/detectors/mlsd.py``).

controlnet-aux ``mlsd/models/mbv2_mlsd_large.py``: a trimmed MobileNetV2
trunk (14 feature blocks, ReLU6, TFLite's asymmetric stride-2 padding: a
zero row and column after the image, then a conv without padding) under
``backbone.features``, and the FPN-style decoder ``block15`` ... ``block23``
(BlockTypeA: two 1x1 conv-BN-ReLU, the deeper one enlarged 2x with
align-corners bilinear, concatenated; BlockTypeB: a residual 3x3 pair;
BlockTypeC: a dilated 3x3, a 3x3 and a 1x1 head), emitting a 9-channel map
at half resolution. ``mlsd_large_512_fp32.pth`` loads as it is; ``fold``
folds every BatchNorm into its conv, as the JAX converter does. The line
decode (``decode_lines``) runs on the map's device; the segments are drawn
on the host (``pose/raster.py``).
"""

from __future__ import annotations

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

# (expand_ratio, out_ch, stride) per InvertedResidual
BLOCKS = [(1, 16, 1),
          (6, 24, 2), (6, 24, 1),
          (6, 32, 2), (6, 32, 1), (6, 32, 1),
          (6, 64, 2), (6, 64, 1), (6, 64, 1), (6, 64, 1),
          (6, 96, 1), (6, 96, 1), (6, 96, 1)]
FPN_SELECTED = (1, 3, 6, 10, 13)


class ConvBNReLU(nn.Sequential):
    """conv (no bias), BatchNorm, ReLU6; stride 2 pads one zero row and
    column after the image and convolves without padding."""

    def __init__(self, cin, cout, k=3, stride=1, groups=1):
        pad = 0 if stride == 2 else (k - 1) // 2
        super().__init__(nn.Conv2d(cin, cout, k, stride, pad, groups=groups,
                                   bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU6())
        self.stride = stride

    def forward(self, x):
        if self.stride == 2:
            x = F.pad(x, (0, 1, 0, 1))
        return super().forward(x)


class InvertedResidual(nn.Module):
    def __init__(self, cin, cout, stride, expand):
        super().__init__()
        hidden = cin * expand
        self.residual = stride == 1 and cin == cout
        layers = [] if expand == 1 else [ConvBNReLU(cin, hidden, 1)]
        layers += [ConvBNReLU(hidden, hidden, 3, stride, groups=hidden),
                   nn.Conv2d(hidden, cout, 1, bias=False),
                   nn.BatchNorm2d(cout)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.residual else self.conv(x)


class MobileNetV2(nn.Module):
    def __init__(self):
        super().__init__()
        feats = [ConvBNReLU(4, 32, 3, 2)]
        cin = 32
        for t, cout, s in BLOCKS:
            feats.append(InvertedResidual(cin, cout, s, t))
            cin = cout
        self.features = nn.Sequential(*feats)

    def forward(self, x):
        out = []
        for i, f in enumerate(self.features):
            x = f(x)
            if i in FPN_SELECTED:
                out.append(x)
        return out


def _cbr(cin, cout, k=1, padding=0, dilation=1):
    return nn.Sequential(nn.Conv2d(cin, cout, k, padding=padding,
                                   dilation=dilation),
                         nn.BatchNorm2d(cout), nn.ReLU())


class BlockTypeA(nn.Module):
    def __init__(self, in_c1, in_c2, out_c1, out_c2, upscale=True):
        super().__init__()
        self.conv1 = _cbr(in_c2, out_c2)
        self.conv2 = _cbr(in_c1, out_c1)
        self.upscale = upscale

    def forward(self, a, b):
        b = self.conv1(b)
        a = self.conv2(a)
        if self.upscale:
            b = up2_align_corners(b)
        return torch.cat([a, b], 1)


class BlockTypeB(nn.Module):
    def __init__(self, in_c, out_c):
        super().__init__()
        self.conv1 = _cbr(in_c, in_c, 3, 1)
        self.conv2 = _cbr(in_c, out_c, 3, 1)

    def forward(self, x):
        return self.conv2(self.conv1(x) + x)


class BlockTypeC(nn.Module):
    def __init__(self, in_c, out_c):
        super().__init__()
        self.conv1 = _cbr(in_c, in_c, 3, 5, 5)
        self.conv2 = _cbr(in_c, in_c, 3, 1)
        self.conv3 = nn.Conv2d(in_c, out_c, 1)

    def forward(self, x):
        return self.conv3(self.conv2(self.conv1(x)))


class MobileV2_MLSD_Large(nn.Module):
    """x: (1, 4, H, W) in [-1, 1] (RGB and a ones plane) -> (1, 9, H / 2,
    W / 2): the line-centre logit, the 4-channel displacement field and 4
    auxiliary channels."""

    def __init__(self):
        super().__init__()
        self.backbone = MobileNetV2()
        self.block15 = BlockTypeA(64, 96, 64, 64, upscale=False)
        self.block16 = BlockTypeB(128, 64)
        self.block17 = BlockTypeA(32, 64, 64, 64)
        self.block18 = BlockTypeB(128, 64)
        self.block19 = BlockTypeA(24, 64, 64, 64)
        self.block20 = BlockTypeB(128, 64)
        self.block21 = BlockTypeA(16, 64, 64, 64)
        self.block22 = BlockTypeB(128, 64)
        self.block23 = BlockTypeC(64, 16)

    def forward(self, x):
        c1, c2, c3, c4, c5 = self.backbone(x)
        x = self.block16(self.block15(c4, c5))
        x = self.block18(self.block17(c3, x))
        x = self.block20(self.block19(c2, x))
        x = self.block22(self.block21(c1, x))
        return self.block23(x)[:, 7:]

    def fold(self) -> "MobileV2_MLSD_Large":
        """Every BatchNorm folded into its conv (in place; -> self)."""
        return fold_bn_pairs(self, sequential_bn_pairs(self))


def decode_lines(tp_map: torch.Tensor, score_thr: float, dist_thr: float,
                 topk: int = 200, ksize: int = 3) -> np.ndarray:
    """controlnet-aux ``utils.py:deccode_output_score_and_ptss`` and the
    ``pred_lines`` filter on a (>= 5, H, W) map on any device: the centre
    logit's sigmoid in f64, a ``ksize`` x ``ksize`` dilate NMS, the
    ``topk`` peaks by score (ties in flat-index order, where the JAX copy's
    ``argpartition`` orders them as it may), then the score and length
    thresholds. -> (N, 4) f64 [x_start, y_start, x_end, y_end] segments at
    map scale, on the host."""
    heat = 1.0 / (1.0 + torch.exp(-tp_map[0].double()))
    hmax = imgproc.dilate(heat, np.ones((ksize, ksize)))
    heat = torch.where(hmax == heat, heat, torch.zeros_like(heat))
    flat = heat.reshape(-1)
    scores, idx = torch.sort(flat, descending=True, stable=True)
    scores, idx = scores[:topk], idx[:topk]
    w = tp_map.shape[2]
    yy, xx = idx // w, idx % w
    d = tp_map[1:5, yy, xx]
    # the length in the map's f32, as numpy takes it
    keep = (scores > score_thr) & (torch.hypot(d[2] - d[0], d[3] - d[1])
                                   > dist_thr)
    d = d.double()
    seg = torch.stack([xx + d[0], yy + d[1], xx + d[2], yy + d[3]], 1)
    return seg[keep].cpu().numpy()


class MLSDdetector:
    """The reference's call protocol (mlsd/__init__.py:41-79,
    utils.py:pred_lines) on the port's network, on ``device`` (None:
    CUDA), in f32 with TF32 off."""

    def __init__(self, model: MobileV2_MLSD_Large, device=None):
        from pcdms_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.model = model.fold().to(self.device).eval()

    @classmethod
    def from_pretrained(cls, weights_path: str, device=None):
        """From ``mlsd_large_512_fp32.pth`` (unpickled: trusted local files
        only)."""
        from pcdms_tpu_torch.pose.detectors.common import empty, load_network
        return cls(load_network(empty(MobileV2_MLSD_Large), weights_path),
                   device)

    @torch.no_grad()
    def __call__(self, input_image, thr_v: float = 0.1, thr_d: float = 0.1,
                 detect_resolution: int = 512,
                 image_resolution: int = 512) -> np.ndarray:
        from pcdms_tpu_torch.pose.dwpose import f32_forward
        from pcdms_tpu_torch.pose.raster import line_pixels
        img = hwc3(as_image(input_image, self.device))
        img = resize_to_64(img, detect_resolution)
        h, w = img.shape[:2]
        # the detect-resized image at its own size, a ones plane added
        # (mlsd/__init__.py:60: input_shape=[h, w])
        feed = torch.cat([img.float(), img.new_ones((h, w, 1)).float()], 2)
        x = feed.permute(2, 0, 1)[None] / 127.5 - 1.0
        with f32_forward():
            tp_map = self.model(x)[0]
        lines = 2.0 * decode_lines(tp_map, thr_v, thr_d)   # map -> image
        out = np.zeros((h, w), np.uint8)
        for x0, y0, x1, y1 in lines.astype(int):
            for px, py in line_pixels(w, h, (int(x0), int(y0)),
                                      (int(x1), int(y1))):
                out[py, px] = 255
        detected = hwc3(torch.from_numpy(out).to(self.device))
        out_hw = shape_to_64(h, w, image_resolution)
        return imgproc.resize(detected, (out_hw[1], out_hw[0]),
                              "linear").cpu().numpy()
