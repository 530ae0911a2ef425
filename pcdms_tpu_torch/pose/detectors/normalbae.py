"""NormalBAE surface-normal detector (EfficientNet-B5 + NNET) as an
``nn.Module``, NCHW (counterpart of
``pcdms_tpu/pose/detectors/normalbae.py``).

controlnet-aux ``normalbae``'s ``NNET`` under the published key names of
``scannet.pt`` (``encoder.original_model.*``: geffnet's
``tf_efficientnet_b5_ap`` with TF-SAME padding, squeeze-excite, swish and
BatchNorm eps 1e-3; ``decoder.*``: the 1x1 bottleneck, four UpSampleBN
skip fusions, the 3x3 coarse head at 1/8 and three pointwise MLP heads at
1/4, 1/2 and 1/1, each followed by ``norm_normalize``). Only the test-time
path runs. ``fold`` folds every BatchNorm into its conv, at eps 1e-3 as the
JAX converter folds them all (the decoder's too). The head's ``bn2`` is
never read (the decoder takes ``conv_head``'s raw output): its keys are
dropped at load.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pcdms_tpu_torch.pose import imgproc
from pcdms_tpu_torch.pose.detectors.common import (
    as_image, fold_bn_pairs, hwc3, resize_to_64, shape_to_64,
)
from pcdms_tpu_torch.pose.detectors.midas import (
    Conv2dSame, resize_align_corners, up2_align_corners,
)

BN_EPS = 1e-3
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)

# (kernel, stride, expansion, out_ch, repeats): B5 scaling
STAGES = [(3, 1, 1, 24, 3), (3, 2, 6, 40, 5), (5, 2, 6, 64, 5),
          (3, 2, 6, 128, 7), (5, 1, 6, 176, 7), (5, 2, 6, 304, 9),
          (3, 1, 6, 512, 3)]
STEM_CH = 48
HEAD_CH = 2048


def _bn(c):
    return nn.BatchNorm2d(c, eps=BN_EPS)


class SqueezeExcite(nn.Module):
    def __init__(self, c, reduced):
        super().__init__()
        self.conv_reduce = nn.Conv2d(c, reduced, 1)
        self.conv_expand = nn.Conv2d(reduced, c, 1)

    def forward(self, x):
        g = F.silu(self.conv_reduce(x.mean((2, 3), keepdim=True)))
        return x * torch.sigmoid(self.conv_expand(g))


class DepthwiseSeparable(nn.Module):
    """geffnet ``DepthwiseSeparableConv`` (stage 0, no expansion)."""

    def __init__(self, cin, cout, k, stride):
        super().__init__()
        self.conv_dw = Conv2dSame(cin, cin, k, stride, groups=cin, bias=False)
        self.bn1 = _bn(cin)
        self.se = SqueezeExcite(cin, max(1, cin // 4))
        self.conv_pw = Conv2dSame(cin, cout, 1, bias=False)
        self.bn2 = _bn(cout)
        self.residual = stride == 1 and cin == cout
        self.pairs = [("conv_dw", "bn1"), ("conv_pw", "bn2")]

    def forward(self, x):
        h = F.silu(self.bn1(self.conv_dw(x)))
        h = self.bn2(self.conv_pw(self.se(h)))
        return x + h if self.residual else h


class InvertedResidual(nn.Module):
    def __init__(self, cin, cout, k, stride, expand):
        super().__init__()
        mid = cin * expand
        self.conv_pw = Conv2dSame(cin, mid, 1, bias=False)
        self.bn1 = _bn(mid)
        self.conv_dw = Conv2dSame(mid, mid, k, stride, groups=mid, bias=False)
        self.bn2 = _bn(mid)
        self.se = SqueezeExcite(mid, max(1, cin // 4))
        self.conv_pwl = Conv2dSame(mid, cout, 1, bias=False)
        self.bn3 = _bn(cout)
        self.residual = stride == 1 and cin == cout
        self.pairs = [("conv_pw", "bn1"), ("conv_dw", "bn2"),
                      ("conv_pwl", "bn3")]

    def forward(self, x):
        h = F.silu(self.bn1(self.conv_pw(x)))
        h = F.silu(self.bn2(self.conv_dw(h)))
        h = self.bn3(self.conv_pwl(self.se(h)))
        return x + h if self.residual else h


class EfficientNet(nn.Module):
    """-> the decoder's skips: [stage 0 (24, 1/2), 1 (40, 1/4), 2 (64,
    1/8), 4 (176, 1/16), conv_head's raw output (2048, 1/32)]."""

    def __init__(self):
        super().__init__()
        self.conv_stem = Conv2dSame(3, STEM_CH, 3, 2, bias=False)
        self.bn1 = _bn(STEM_CH)
        stages, cin = [], STEM_CH
        for k, s, e, cout, reps in STAGES:
            blocks = []
            for bi in range(reps):
                stride = s if bi == 0 else 1
                blocks.append(DepthwiseSeparable(cin, cout, k, stride)
                              if e == 1 else
                              InvertedResidual(cin, cout, k, stride, e))
                cin = cout
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        # the published bn2 after it is never read, so not held here
        self.conv_head = Conv2dSame(cin, HEAD_CH, 1, bias=False)

    def forward(self, x) -> List[torch.Tensor]:
        h = F.silu(self.bn1(self.conv_stem(x)))
        skips = []
        for si, stage in enumerate(self.blocks):
            h = stage(h)
            if si in (0, 1, 2, 4):
                skips.append(h)
        skips.append(self.conv_head(h))
        return skips


class Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.original_model = EfficientNet()


class UpSampleBN(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self._net = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1), _bn(cout), nn.LeakyReLU(),
            nn.Conv2d(cout, cout, 3, padding=1), _bn(cout), nn.LeakyReLU())

    def forward(self, x, skip):
        h = resize_align_corners(x, skip.shape[2], skip.shape[3])
        return self._net(torch.cat([h, skip], 1))


def norm_normalize(n: torch.Tensor) -> torch.Tensor:
    """Unit xyz and kappa = elu(k) + 1.01 on (N, 4, H, W)."""
    xyz, kappa = n[:, :3], n[:, 3:4]
    norm = torch.sqrt((xyz ** 2).sum(1, keepdim=True)) + 1e-10
    return torch.cat([xyz / norm, F.elu(kappa) + 1.0 + 0.01], 1)


def _mlp(cin):
    return nn.Sequential(nn.Conv1d(cin, 128, 1), nn.ReLU(),
                         nn.Conv1d(128, 128, 1), nn.ReLU(),
                         nn.Conv1d(128, 128, 1), nn.ReLU(),
                         nn.Conv1d(128, 4, 1))


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv2 = nn.Conv2d(HEAD_CH, HEAD_CH, 1)
        self.up1 = UpSampleBN(HEAD_CH + 176, 1024)
        self.up2 = UpSampleBN(1024 + 64, 512)
        self.up3 = UpSampleBN(512 + 40, 256)
        self.up4 = UpSampleBN(256 + 24, 128)
        self.out_conv_res8 = nn.Conv2d(512, 4, 3, padding=1)
        self.out_conv_res4 = _mlp(512 + 4)
        self.out_conv_res2 = _mlp(256 + 4)
        self.out_conv_res1 = _mlp(128 + 4)

    @staticmethod
    def _head(mlp, feat):
        b, c, h, w = feat.shape
        return mlp(feat.reshape(b, c, h * w)).reshape(b, -1, h, w)

    def forward(self, feats):
        b0, b1, b2, b4, head = feats
        x_d0 = self.conv2(head)
        x_d1 = self.up1(x_d0, b4)
        x_d2 = self.up2(x_d1, b2)
        x_d3 = self.up3(x_d2, b1)
        x_d4 = self.up4(x_d3, b0)
        out = norm_normalize(self.out_conv_res8(x_d2))
        for mlp, x_d in ((self.out_conv_res4, x_d2),
                         (self.out_conv_res2, x_d3),
                         (self.out_conv_res1, x_d4)):
            feat = torch.cat([up2_align_corners(x_d), up2_align_corners(out)],
                             1)
            out = norm_normalize(self._head(mlp, feat))
        return out


class NNET(nn.Module):
    """x: (B, 3, H, W) ImageNet-normalised RGB, H and W multiples of 32 ->
    (B, 4, H, W): unit normals and kappa."""

    def __init__(self):
        super().__init__()
        self.encoder = Encoder()
        self.decoder = Decoder()

    def fold(self) -> "NNET":
        """Every BatchNorm folded into its conv (in place; -> self)."""
        enc = "encoder.original_model"
        pairs = [(f"{enc}.conv_stem", f"{enc}.bn1")]
        for name, m in self.named_modules():
            if isinstance(m, (DepthwiseSeparable, InvertedResidual)):
                pairs += [(f"{name}.{c}", f"{name}.{b}") for c, b in m.pairs]
        for i in range(1, 5):
            pairs += [(f"decoder.up{i}._net.0", f"decoder.up{i}._net.1"),
                      (f"decoder.up{i}._net.3", f"decoder.up{i}._net.4")]
        return fold_bn_pairs(self, pairs)

    def forward(self, x):
        return self.decoder(self.encoder.original_model(x))


class NormalBaeDetector:
    """The reference's call protocol (normalbae/__init__.py:63-108) on the
    port's network, on ``device`` (None: CUDA), in f32 with TF32 off."""

    def __init__(self, model: NNET, device=None):
        from pcdms_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.model = model.fold().to(self.device).eval()

    @classmethod
    def from_pretrained(cls, weights_path: str, device=None):
        """From ``scannet.pt`` (its ``model`` dict, ``module.`` taken off;
        unpickled: trusted local files only)."""
        from pcdms_tpu_torch.pose.detectors.common import empty, load_network
        return cls(load_network(empty(NNET), weights_path),
                   device)

    @torch.no_grad()
    def __call__(self, input_image, detect_resolution: int = 512,
                 image_resolution: int = 512) -> np.ndarray:
        from pcdms_tpu_torch.pose.dwpose import f32_forward
        img = hwc3(as_image(input_image, self.device))
        img = resize_to_64(img, detect_resolution)
        mean = torch.from_numpy(MEAN).to(self.device)
        std = torch.from_numpy(STD).to(self.device)
        x = (img.float() / 255.0 - mean) / std
        with f32_forward():
            out = self.model(x.permute(2, 0, 1)[None])[0]
        normal = ((out[:3] + 1.0) * 0.5).clamp(0, 1).permute(1, 2, 0)
        detected = hwc3((normal * 255.0).clamp(0, 255).to(torch.uint8))
        out_hw = shape_to_64(*img.shape[:2], image_resolution)
        return imgproc.resize(detected.contiguous(), (out_hw[1], out_hw[0]),
                              "linear").cpu().numpy()
