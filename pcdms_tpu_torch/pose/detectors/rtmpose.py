"""RTMPose-l / DWPose-l wholebody keypoint model (mmpose's graph) as
``nn.Module``s, NCHW (counterpart of ``pcdms_tpu/pose/detectors/rtmpose.py``).

  * CSPNeXt-l backbone (P5, deepen / widen 1.0, expand ratio 0.5): a
    3-conv stem, then four stages of a stride-2 ConvModule and a CSP layer
    of CSPNeXt blocks (3x3 ConvModule, 5x5 depthwise ConvModule, 1x1
    pointwise ConvModule, all at the branch's width) with channel attention
    (global mean, 1x1 conv, hard sigmoid); SPP in stage 4 -> 1024 channels
    at stride 32. 33.6M parameters, 9.98 GMACs a 384x288 crop; with the
    17-keypoint head at 256x192 the same backbone makes 27.6M parameters
    and 4.07 GMACs, mmpose's published RTMPose-l. (The JAX package's
    ``rtmpose_init`` builds the blocks at half the width; its
    ``convert_rtmpose`` and ``rtmpose_apply`` take the widths from the
    weights, so both packages run the same checkpoint.);
  * RTMCCHead: a 7x7 conv to 133 keypoint tokens of 12 x 9 = 108 values
    (flattened row-major), ScaleNorm and a linear to 256, one gated
    attention unit (a shared 128-d base turned into q and k by ``gamma`` /
    ``beta``, the kernel ``relu(q k^T / sqrt(128))^2``: a plain product,
    not softmax attention, gating by u), then two bias-free linears to
    SimCC x (576 bins) and y (768 bins).

The ``state_dict()`` has mmpose's key names (``backbone.stage2.1.blocks.0
.conv2.depthwise_conv.bn``, ``head.gau.uv``, ``head.mlp.0.g``, ...), so an
mmpose checkpoint loads with ``strict=True``; ``common.fold_bn`` then folds
every BatchNorm (eps 1e-5), the depthwise convs' too, as the JAX package's
``convert_rtmpose`` does. The forward takes raw 0-255 RGB crops (B, 3, 384,
288) and applies the ImageNet mean and std itself.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pcdms_tpu_torch.pose.detectors.common import ConvModule, SPPBottleneck

BN_EPS = 1e-5                  # SyncBN default (dwpose-l config)
MEAN = (123.675, 116.28, 103.53)           # RGB
STD = (58.395, 57.12, 57.375)
# (in, out, num_blocks, add_identity, use_spp): CSPNeXt P5 at
# deepen / widen 1.0
CSPNEXT_ARCH = [
    (64, 128, 3, True, False),
    (128, 256, 6, True, False),
    (256, 512, 6, True, False),
    (512, 1024, 3, False, True),
]
NUM_KPTS = 133
FEAT_HW = (12, 9)              # 384 x 288 / 32
HIDDEN = 256
GAU_S = 128
GAU_E = 512                    # hidden * expansion factor 2
SCALE_NORM_EPS = 1e-5
SIMCC_X = 576                  # 288 * simcc split ratio 2
SIMCC_Y = 768                  # 384 * 2


class DepthwiseSeparableConvModule(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.depthwise_conv = ConvModule(cin, cin, k, eps=BN_EPS, groups=cin)
        self.pointwise_conv = ConvModule(cin, cout, 1, eps=BN_EPS)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class CSPNeXtBlock(nn.Module):
    """At the width of its CSP layer's branch (mmdet's CSPLayer builds its
    blocks at expansion 1.0)."""

    def __init__(self, c: int, add_identity: bool):
        super().__init__()
        self.add_identity = add_identity
        self.conv1 = ConvModule(c, c, 3, eps=BN_EPS)
        self.conv2 = DepthwiseSeparableConvModule(c, c, 5)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.add_identity else y


class ChannelAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc = nn.Conv2d(c, c, 1)

    def forward(self, x):
        return x * F.hardsigmoid(self.fc(x.mean((2, 3), keepdim=True)))


class CSPNeXtLayer(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, add_identity: bool):
        super().__init__()
        mid = cout // 2
        self.main_conv = ConvModule(cin, mid, 1, eps=BN_EPS)
        self.short_conv = ConvModule(cin, mid, 1, eps=BN_EPS)
        self.final_conv = ConvModule(2 * mid, cout, 1, eps=BN_EPS)
        self.attention = ChannelAttention(2 * mid)
        self.blocks = nn.Sequential(*[CSPNeXtBlock(mid, add_identity)
                                      for _ in range(n)])

    def forward(self, x):
        cat = torch.cat([self.blocks(self.main_conv(x)), self.short_conv(x)],
                        1)
        return self.final_conv(self.attention(cat))


class CSPNeXt(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = nn.Sequential(ConvModule(3, 32, 3, 2, eps=BN_EPS),
                                  ConvModule(32, 32, 3, eps=BN_EPS),
                                  ConvModule(32, 64, 3, eps=BN_EPS))
        for si, (cin, cout, n, add, spp) in enumerate(CSPNEXT_ARCH, 1):
            layers = [ConvModule(cin, cout, 3, 2, eps=BN_EPS)]
            if spp:
                layers.append(SPPBottleneck(cout, cout, BN_EPS))
            layers.append(CSPNeXtLayer(cout, cout, n, add))
            setattr(self, f"stage{si}", nn.Sequential(*layers))

    def forward(self, x):
        h = self.stem(x)
        for si in range(1, len(CSPNEXT_ARCH) + 1):
            h = getattr(self, f"stage{si}")(h)
        return h


class ScaleNorm(nn.Module):
    """x / max(||x|| / sqrt(d), eps) * g."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = dim ** -0.5
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x):
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * self.scale
        return x / norm.clamp(min=SCALE_NORM_EPS) * self.g


class Scale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.scale


class RTMCCBlock(nn.Module):
    """mmpose's gated attention unit, self-attention mode, no relative bias
    or position encoding, SiLU, residual through ``res_scale``."""

    def __init__(self):
        super().__init__()
        self.ln = ScaleNorm(HIDDEN)
        self.uv = nn.Linear(HIDDEN, 2 * GAU_E + GAU_S, bias=False)
        self.gamma = nn.Parameter(torch.rand(2, GAU_S))
        self.beta = nn.Parameter(torch.rand(2, GAU_S))
        self.o = nn.Linear(GAU_E, HIDDEN, bias=False)
        self.res_scale = Scale(HIDDEN)

    def forward(self, x):
        uv = F.silu(self.uv(self.ln(x)))
        u, v, base = torch.split(uv, [GAU_E, GAU_E, GAU_S], dim=-1)
        qk = base[:, :, None, :] * self.gamma + self.beta
        q, k = qk.unbind(2)
        kernel = F.relu(torch.matmul(q, k.transpose(1, 2))
                        / math.sqrt(GAU_S)).square()
        return self.res_scale(x) + self.o(u * torch.matmul(kernel, v))


class RTMCCHead(nn.Module):
    def __init__(self):
        super().__init__()
        flat = FEAT_HW[0] * FEAT_HW[1]
        self.final_layer = nn.Conv2d(1024, NUM_KPTS, 7, padding=3)
        self.mlp = nn.Sequential(ScaleNorm(flat),
                                 nn.Linear(flat, HIDDEN, bias=False))
        self.gau = RTMCCBlock()
        self.cls_x = nn.Linear(HIDDEN, SIMCC_X, bias=False)
        self.cls_y = nn.Linear(HIDDEN, SIMCC_Y, bias=False)

    def forward(self, feat):
        tokens = self.gau(self.mlp(self.final_layer(feat).flatten(2)))
        return self.cls_x(tokens), self.cls_y(tokens)


class RTMPose(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = CSPNeXt()
        self.head = RTMCCHead()
        self.register_buffer("mean", torch.tensor(MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x):
        """x: (B, 3, 384, 288) raw 0-255 RGB -> (simcc_x (B, 133, 576),
        simcc_y (B, 133, 768))."""
        return self.head(self.backbone((x - self.mean) / self.std))
