"""YOLOX-l person detector (mmdet's graph) as ``nn.Module``s, NCHW
(counterpart of ``pcdms_tpu/pose/detectors/yolox.py``).

CSPDarknet (deepen / widen 1.0, outputs of stages 2-4, SPP 5 / 9 / 13 in
stage 4), YOLOXPAFPN (256 channels at every level, 3 CSP blocks) and the
decoupled YOLOXHead (2 stacked 3x3 convs of 256 for classes and for boxes).
The ``state_dict()`` has mmdet's key names (``backbone.stem.conv.conv``,
``neck.reduce_layers.0.bn``, ``bbox_head.multi_level_conv_obj.2``, ...), so
an mmdet checkpoint loads with ``strict=True``; ``common.fold_bn`` then
folds every BatchNorm (eps 1e-3) into its conv, as the JAX package's
``convert_yolox`` does.

Input: raw 0-255 BGR, (B, 3, H, W) f32, no normalisation. Output:
(B, sum of H*W over strides 8 / 16 / 32, 85) packed [xy, wh, sigmoid(obj),
sigmoid(cls)] per anchor point, each level flattened row-major over (H, W),
the layout ``pose/dwpose.py::decode_yolox`` reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pcdms_tpu_torch.pose.detectors.common import ConvModule, SPPBottleneck

BN_EPS = 1e-3           # norm_cfg eps 0.001 (yolox_l config)
NUM_CLASSES = 80
# (in, out, num_blocks, add_identity, use_spp): mmdet's P5 arch at
# deepen / widen 1.0
DARKNET_ARCH = [
    (64, 128, 3, True, False),
    (128, 256, 9, True, False),
    (256, 512, 9, True, False),
    (512, 1024, 3, False, True),
]


class DarknetBottleneck(nn.Module):
    def __init__(self, c: int, add_identity: bool):
        super().__init__()
        self.add_identity = add_identity
        self.conv1 = ConvModule(c, c, 1, eps=BN_EPS)
        self.conv2 = ConvModule(c, c, 3, eps=BN_EPS)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.add_identity else y


class CSPLayer(nn.Module):
    """Main / short 1x1 split at half the output channels, ``n``
    DarknetBottlenecks on the main branch, 1x1 merge."""

    def __init__(self, cin: int, cout: int, n: int, add_identity: bool):
        super().__init__()
        mid = cout // 2
        self.main_conv = ConvModule(cin, mid, 1, eps=BN_EPS)
        self.short_conv = ConvModule(cin, mid, 1, eps=BN_EPS)
        self.final_conv = ConvModule(2 * mid, cout, 1, eps=BN_EPS)
        self.blocks = nn.Sequential(*[DarknetBottleneck(mid, add_identity)
                                      for _ in range(n)])

    def forward(self, x):
        return self.final_conv(torch.cat(
            [self.blocks(self.main_conv(x)), self.short_conv(x)], 1))


class Focus(nn.Module):
    """Space to depth, channels [top-left, bottom-left, top-right,
    bottom-right], then a 3x3 ConvModule."""

    def __init__(self):
        super().__init__()
        self.conv = ConvModule(12, 64, 3, eps=BN_EPS)

    def forward(self, x):
        return self.conv(torch.cat(
            [x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
             x[..., 1::2, 1::2]], 1))


class CSPDarknet(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = Focus()
        for si, (cin, cout, n, add, spp) in enumerate(DARKNET_ARCH, 1):
            layers = [ConvModule(cin, cout, 3, 2, eps=BN_EPS)]
            if spp:
                layers.append(SPPBottleneck(cout, cout, BN_EPS))
            layers.append(CSPLayer(cout, cout, n, add))
            setattr(self, f"stage{si}", nn.Sequential(*layers))

    def forward(self, x):
        h = self.stage1(self.stem(x))
        c3 = self.stage2(h)
        c4 = self.stage3(c3)
        return c3, c4, self.stage4(c4)


def _upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOXPAFPN(nn.Module):
    def __init__(self):
        super().__init__()
        self.reduce_layers = nn.ModuleList([
            ConvModule(1024, 512, 1, eps=BN_EPS),
            ConvModule(512, 256, 1, eps=BN_EPS)])
        self.top_down_blocks = nn.ModuleList([
            CSPLayer(1024, 512, 3, False), CSPLayer(512, 256, 3, False)])
        self.downsamples = nn.ModuleList([
            ConvModule(256, 256, 3, 2, eps=BN_EPS),
            ConvModule(512, 512, 3, 2, eps=BN_EPS)])
        self.bottom_up_blocks = nn.ModuleList([
            CSPLayer(512, 512, 3, False), CSPLayer(1024, 1024, 3, False)])
        self.out_convs = nn.ModuleList([
            ConvModule(c, 256, 1, eps=BN_EPS) for c in (256, 512, 1024)])

    def forward(self, feats):
        c3, c4, c5 = feats
        r0 = self.reduce_layers[0](c5)
        td0 = self.top_down_blocks[0](torch.cat([_upsample2(r0), c4], 1))
        r1 = self.reduce_layers[1](td0)
        td1 = self.top_down_blocks[1](torch.cat([_upsample2(r1), c3], 1))
        bu0 = self.bottom_up_blocks[0](
            torch.cat([self.downsamples[0](td1), r1], 1))
        bu1 = self.bottom_up_blocks[1](
            torch.cat([self.downsamples[1](bu0), r0], 1))
        return [conv(f) for conv, f in zip(self.out_convs, (td1, bu0, bu1))]


class YOLOXHead(nn.Module):
    def __init__(self):
        super().__init__()

        def stacked():
            return nn.ModuleList([nn.Sequential(
                ConvModule(256, 256, 3, eps=BN_EPS),
                ConvModule(256, 256, 3, eps=BN_EPS)) for _ in range(3)])

        self.multi_level_cls_convs = stacked()
        self.multi_level_reg_convs = stacked()
        self.multi_level_conv_cls = nn.ModuleList(
            [nn.Conv2d(256, NUM_CLASSES, 1) for _ in range(3)])
        self.multi_level_conv_reg = nn.ModuleList(
            [nn.Conv2d(256, 4, 1) for _ in range(3)])
        self.multi_level_conv_obj = nn.ModuleList(
            [nn.Conv2d(256, 1, 1) for _ in range(3)])

    def forward(self, feats):
        outs = []
        for lvl, x in enumerate(feats):
            cf = self.multi_level_cls_convs[lvl](x)
            rf = self.multi_level_reg_convs[lvl](x)
            packed = torch.cat([
                self.multi_level_conv_reg[lvl](rf),
                torch.sigmoid(self.multi_level_conv_obj[lvl](rf)),
                torch.sigmoid(self.multi_level_conv_cls[lvl](cf))], 1)
            outs.append(packed.permute(0, 2, 3, 1).flatten(1, 2))
        return torch.cat(outs, 1)


class YOLOX(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = CSPDarknet()
        self.neck = YOLOXPAFPN()
        self.bbox_head = YOLOXHead()

    def forward(self, x):
        return self.bbox_head(self.neck(self.backbone(x)))
