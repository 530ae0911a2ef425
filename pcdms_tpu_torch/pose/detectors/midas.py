"""MiDaS DPT-Hybrid monocular depth detector as an ``nn.Module``, NCHW
(counterpart of ``pcdms_tpu/pose/detectors/midas.py``).

controlnet-aux's ``DPTDepthModel`` on timm's ``vit_base_resnet50_384``,
under the published key names of ``dpt_hybrid-midas-501f0c75.pt``
(``pretrained.model.*``, ``pretrained.act_postprocess{3,4}.*``,
``scratch.*``):

  * the ResNetV2 stem and stages (3 / 4 / 9 bottlenecks) of
    weight-standardised convs with TF-SAME padding, GroupNorm(32) + ReLU;
    ``fold`` standardises the weights once, in f64, as the JAX converter
    does;
  * a 1x1 patch projection to 768-d tokens, the cls token and the 24 x 24
    position table resized to the token grid, 12 pre-LN ViT blocks with
    plain ``softmax(q k^T / sqrt(d)) v`` attention;
  * project-readout reassembly of blocks 8 and 11, 3x3 scratch convs to 256,
    four fusion blocks with align-corners 2x upsampling, the depth head.

The helpers shared with NormalBAE, ZoeDepth, LeReS and M-LSD live here:
``same_pad`` / ``Conv2dSame``, ``resize_align_corners`` /
``up2_align_corners`` and ``linear_resize``.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pcdms_tpu_torch.pose import imgproc
from pcdms_tpu_torch.pose.detectors.common import (
    as_image, hwc3, resize_to_64, shape_to_64,
)

GN_GROUPS = 32
VIT_DIM = 768
VIT_HEADS = 12
DEPTHS = (3, 4, 9)
STAGE_CH = (256, 512, 1024)
FEATURES = (256, 512, 768, 768)       # reassemble channels per hook
SCRATCH = 256


# ---------------------------------------------------------------------------
# shared primitives
# ---------------------------------------------------------------------------

def same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF-SAME (before, after) padding of an axis (timm's ``*Same``
    layers)."""
    out = -(-size // s)
    pad = max(0, (out - 1) * s + k - size)
    return pad // 2, pad - pad // 2


def pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """``x`` (N, C, H, W) padded TF-SAME for a k x k window at stride s."""
    ph = same_pad(x.shape[2], k, s)
    pw = same_pad(x.shape[3], k, s)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


class Conv2dSame(nn.Conv2d):
    """``nn.Conv2d`` with TF-SAME padding computed from the input."""

    def __init__(self, cin, cout, k, stride=1, groups=1, bias=True):
        super().__init__(cin, cout, k, stride, 0, groups=groups, bias=bias)

    def forward(self, x):
        return super().forward(pad_same(x, self.kernel_size[0],
                                        self.stride[0]))


class StdConv2dSame(Conv2dSame):
    """timm's ``StdConv2dSame`` (eps 1e-8, no bias): the weight standardised
    over (in, kh, kw) at each call, or once by ``standardize``."""

    def __init__(self, cin, cout, k, stride=1, eps=1e-8):
        super().__init__(cin, cout, k, stride, bias=False)
        self.eps = eps
        self.standardized = False

    @torch.no_grad()
    def standardize(self) -> None:
        """The weight standardised in place, in f64 as the JAX converter's
        ``_std_weight`` computes it."""
        if self.standardized:
            return
        w = self.weight.detach().cpu().numpy().astype(np.float64)
        mean = w.mean(axis=(1, 2, 3), keepdims=True)
        var = w.var(axis=(1, 2, 3), keepdims=True)
        std = ((w - mean) / np.sqrt(var + self.eps)).astype(np.float32)
        self.weight.copy_(torch.from_numpy(std))
        self.standardized = True

    def forward(self, x):
        w = self.weight
        if not self.standardized:
            w = F.batch_norm(w.reshape(1, self.out_channels, -1), None, None,
                             training=True, momentum=0.0,
                             eps=self.eps).reshape_as(w)
        return F.conv2d(pad_same(x, self.kernel_size[0], self.stride[0]), w,
                        None, self.stride)


def _align_corners_taps(n: int, m: int, device):
    pos = np.linspace(0.0, n - 1.0, m)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, n - 1)
    t = (pos - i0).astype(np.float32)
    return [torch.from_numpy(v).to(device) for v in (i0, i1, t)]


def resize_align_corners(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``F.interpolate(x, (h, w), mode="bilinear", align_corners=True)`` on
    (N, C, H, W), as the JAX package computes it: the source positions by
    ``np.linspace`` in f64, the weights in f32, rows then columns."""
    if tuple(x.shape[2:]) == (h, w):
        return x
    y0, y1, ty = _align_corners_taps(x.shape[2], h, x.device)
    x0, x1, tx = _align_corners_taps(x.shape[3], w, x.device)
    ty = ty.to(x.dtype)[:, None]
    tx = tx.to(x.dtype)
    top = x.index_select(2, y0) * (1 - ty) + x.index_select(2, y1) * ty
    return (top.index_select(3, x0) * (1 - tx)
            + top.index_select(3, x1) * tx)


def up2_align_corners(x: torch.Tensor) -> torch.Tensor:
    """``F.interpolate(scale_factor=2, mode="bilinear",
    align_corners=True)``."""
    return resize_align_corners(x, 2 * x.shape[2], 2 * x.shape[3])


def linear_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(C, H, W) -> (C, h, w) as ``jax.image.resize(..., "linear")``:
    bilinear at half-pixel centres, antialiased where an axis shrinks
    (PyTorch's ``antialias=True`` bilinear, within an f32 rounding), as the
    JAX package resizes MiDaS's position table and BEiT's bias tables."""
    return F.interpolate(x[None], (h, w), mode="bilinear",
                         align_corners=False, antialias=True)[0]


# ---------------------------------------------------------------------------
# the ResNetV2 hybrid stem and stages
# ---------------------------------------------------------------------------

class GroupNormAct(nn.GroupNorm):
    def __init__(self, c: int, act: bool = True):
        super().__init__(GN_GROUPS, c, eps=1e-5)
        self.act = act

    def forward(self, x):
        x = super().forward(x)
        return F.relu(x) if self.act else x


class DownsampleConv(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv = StdConv2dSame(cin, cout, 1, stride)
        self.norm = GroupNormAct(cout, act=False)

    def forward(self, x):
        return self.norm(self.conv(x))


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, stride, downsample):
        super().__init__()
        mid = cout // 4
        self.conv1 = StdConv2dSame(cin, mid, 1)
        self.norm1 = GroupNormAct(mid)
        self.conv2 = StdConv2dSame(mid, mid, 3, stride)
        self.norm2 = GroupNormAct(mid)
        self.conv3 = StdConv2dSame(mid, cout, 1)
        self.norm3 = GroupNormAct(cout, act=False)
        self.downsample = (DownsampleConv(cin, cout, stride) if downsample
                           else None)

    def forward(self, x):
        sc = x if self.downsample is None else self.downsample(x)
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return F.relu(h + sc)


class Stage(nn.Module):
    def __init__(self, cin, cout, depth, stride):
        super().__init__()
        self.blocks = nn.Sequential(*[
            Bottleneck(cin if i == 0 else cout, cout, stride if i == 0 else 1,
                       i == 0) for i in range(depth)])

    def forward(self, x):
        return self.blocks(x)


class Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = StdConv2dSame(3, 64, 7, 2)
        self.norm = GroupNormAct(64)

    def forward(self, x):
        h = self.norm(self.conv(x))
        return F.max_pool2d(pad_same(h, 3, 2, float("-inf")), 3, 2)


class ResNetV2(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = Stem()
        cin, stages = 64, []
        for si, (depth, cout) in enumerate(zip(DEPTHS, STAGE_CH)):
            stages.append(Stage(cin, cout, depth, 1 if si == 0 else 2))
            cin = cout
        self.stages = nn.Sequential(*stages)

    def forward(self, x) -> List[torch.Tensor]:
        h = self.stem(x)
        outs = []
        for stage in self.stages:
            h = stage(h)
            outs.append(h)
        return outs            # strides 4, 8, 16; 256 / 512 / 1024 channels


# ---------------------------------------------------------------------------
# the ViT trunk
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, t, c = x.shape
        hd = c // self.heads
        q, k, v = self.qkv(x).reshape(b, t, 3, self.heads, hd).permute(
            2, 0, 3, 1, 4)
        attn = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(hd), -1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, t, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim=VIT_DIM, heads=VIT_HEADS):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class HybridEmbed(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = ResNetV2()
        self.proj = nn.Conv2d(STAGE_CH[-1], VIT_DIM, 1)


class VitHybrid(nn.Module):
    def __init__(self):
        super().__init__()
        self.patch_embed = HybridEmbed()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, VIT_DIM))
        self.pos_embed = nn.Parameter(torch.zeros(1, 577, VIT_DIM))
        self.blocks = nn.ModuleList([Block() for _ in range(12)])


class ProjectReadout(nn.Module):
    """Every patch token concatenated with the cls token, linear 1536 ->
    768, GELU (``act_postprocess*.0``)."""

    def __init__(self, dim):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):
        cls = tokens[:, :1].expand_as(tokens[:, 1:])
        return self.project(torch.cat([tokens[:, 1:], cls], -1))


def tokens_to_map(tokens: torch.Tensor, gs_h: int, gs_w: int):
    b, _, c = tokens.shape
    return tokens.transpose(1, 2).reshape(b, c, gs_h, gs_w)


def resize_pos_embed(pos_embed: torch.Tensor, gs_h: int, gs_w: int):
    """The square position table (cls first) resized to a gs_h x gs_w grid
    (``linear_resize``, the JAX package's resize)."""
    tok, grid = pos_embed[:, :1], pos_embed[0, 1:]
    gs_old = int(math.sqrt(grid.shape[0]))
    if (gs_h, gs_w) == (gs_old, gs_old):
        return pos_embed
    grid = grid.reshape(gs_old, gs_old, -1).permute(2, 0, 1)
    grid = linear_resize(grid, gs_h, gs_w).permute(1, 2, 0)
    return torch.cat([tok, grid.reshape(1, gs_h * gs_w, -1)], 1)


# ---------------------------------------------------------------------------
# the DPT neck and head
# ---------------------------------------------------------------------------

class ResidualConvUnit(nn.Module):
    def __init__(self, c=SCRATCH):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, c=SCRATCH):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(c)
        self.resConfUnit2 = ResidualConvUnit(c)
        self.out_conv = nn.Conv2d(c, c, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(up2_align_corners(self.resConfUnit2(x)))


class Scratch(nn.Module):
    def __init__(self, features=FEATURES):
        super().__init__()
        for i, c in enumerate(features, 1):
            setattr(self, f"layer{i}_rn",
                    nn.Conv2d(c, SCRATCH, 3, padding=1, bias=False))
            setattr(self, f"refinenet{i}", FeatureFusionBlock())
        self.output_conv = nn.Sequential(
            nn.Conv2d(SCRATCH, SCRATCH // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(SCRATCH // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU())

    def fuse(self, layers):
        """(layer1 .. layer4) -> (layer4_rn, [r4, r3, r2, r1])."""
        rn = [getattr(self, f"layer{i}_rn")(lyr)
              for i, lyr in enumerate(layers, 1)]
        r4 = self.refinenet4(rn[3])
        r3 = self.refinenet3(r4, rn[2])
        r2 = self.refinenet2(r3, rn[1])
        r1 = self.refinenet1(r2, rn[0])
        return rn[3], [r4, r3, r2, r1]

    def head(self, path):
        """-> (the 32-channel activation before the last conv, the
        non-negative depth (N, H, W))."""
        oc = self.output_conv
        act = F.relu(oc[2](up2_align_corners(oc[0](path))))
        return act, F.relu(oc[4](act))[:, 0]


class Pretrained(nn.Module):
    def __init__(self):
        super().__init__()
        self.model = VitHybrid()
        self.act_postprocess3 = nn.Sequential(
            ProjectReadout(VIT_DIM), nn.Identity(), nn.Identity(),
            nn.Conv2d(VIT_DIM, FEATURES[2], 1))
        self.act_postprocess4 = nn.Sequential(
            ProjectReadout(VIT_DIM), nn.Identity(), nn.Identity(),
            nn.Conv2d(VIT_DIM, FEATURES[3], 1),
            nn.Conv2d(FEATURES[3], FEATURES[3], 3, stride=2, padding=1))


class DPTHybrid(nn.Module):
    """x: (B, 3, H, W) in [-1, 1], H and W multiples of 32 -> (B, H, W)
    non-negative inverse depth."""

    def __init__(self):
        super().__init__()
        self.pretrained = Pretrained()
        self.scratch = Scratch()

    def fold(self) -> "DPTHybrid":
        """Every weight-standardised conv standardised once (in place;
        -> self)."""
        for m in self.modules():
            if isinstance(m, StdConv2dSame):
                m.standardize()
        return self

    def forward(self, x):
        b, _, h, w = x.shape
        gs_h, gs_w = h // 16, w // 16
        vit = self.pretrained.model
        layer1, layer2, feat16 = vit.patch_embed.backbone(x)
        tokens = vit.patch_embed.proj(feat16).flatten(2).transpose(1, 2)
        tokens = torch.cat([vit.cls_token.expand(b, -1, -1), tokens], 1)
        tokens = tokens + resize_pos_embed(vit.pos_embed, gs_h, gs_w)
        hooks = {}
        for i, blk in enumerate(vit.blocks):
            tokens = blk(tokens)
            if i in (8, 11):
                hooks[i] = tokens
        pp3, pp4 = self.pretrained.act_postprocess3, \
            self.pretrained.act_postprocess4
        layer3 = pp3[3](tokens_to_map(pp3[0](hooks[8]), gs_h, gs_w))
        layer4 = pp4[4](pp4[3](tokens_to_map(pp4[0](hooks[11]), gs_h, gs_w)))
        _, (_, _, _, r1) = self.scratch.fuse((layer1, layer2, layer3, layer4))
        return self.scratch.head(r1)[1]


class MidasDetector:
    """``MidasDetector.__call__(image, a, bg_th, depth_and_normal,
    detect_resolution, image_resolution)`` (midas/__init__.py) on the
    port's network, on ``device`` (None: CUDA), in f32 with TF32 off."""

    def __init__(self, model: DPTHybrid, device=None):
        from pcdms_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.model = model.fold().to(self.device).eval()

    @classmethod
    def from_pretrained(cls, weights_path: str, device=None):
        """From ``dpt_hybrid-midas-501f0c75.pt`` (unpickled: trusted local
        files only)."""
        from pcdms_tpu_torch.pose.detectors.common import empty, load_network
        return cls(load_network(empty(DPTHybrid), weights_path), device)

    @torch.no_grad()
    def __call__(self, input_image, a: float = 2.0 * np.pi,
                 bg_th: float = 0.1, depth_and_normal: bool = False,
                 detect_resolution: int = 512, image_resolution: int = 512):
        from pcdms_tpu_torch.pose.dwpose import f32_forward
        img = hwc3(as_image(input_image, self.device))
        img = resize_to_64(img, detect_resolution)
        x = img.permute(2, 0, 1)[None].float() / 127.5 - 1.0
        with f32_forward():
            depth = self.model(x)[0]
        depth_pt = depth - depth.min()
        depth_pt = depth_pt / max(float(depth_pt.max()), 1e-12)
        depth_image = hwc3((depth_pt * 255.0).clamp(0, 255).to(torch.uint8))
        out_hw = shape_to_64(*img.shape[:2], image_resolution)
        size = (out_hw[1], out_hw[0])
        depth_image = imgproc.resize(depth_image, size, "linear")
        if not depth_and_normal:
            return depth_image.cpu().numpy()
        gx = imgproc.sobel(depth, 1, 0)
        gy = imgproc.sobel(depth, 0, 1)
        bg = depth_pt < bg_th
        gx = torch.where(bg, 0.0, gx)
        gy = torch.where(bg, 0.0, gy)
        normal = torch.stack([gx, gy, torch.ones_like(gx) * a], 2)
        normal = normal / (normal ** 2.0).sum(2, keepdim=True) ** 0.5
        normal_image = (normal * 127.5 + 127.5).clamp(0, 255).to(
            torch.uint8).flip(2)
        normal_image = imgproc.resize(normal_image.contiguous(), size,
                                      "linear")
        return depth_image.cpu().numpy(), normal_image.cpu().numpy()
