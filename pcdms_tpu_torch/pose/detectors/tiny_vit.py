"""MobileSAM's TinyViT-5M image encoder (SAM vit_t) as an ``nn.Module``,
NCHW (counterpart of ``pcdms_tpu/pose/detectors/tiny_vit.py``).

``tiny_vit_sam.py`` with ``build_sam.py``'s configuration, under the keys
of ``mobile_sam.pt`` (``image_encoder.patch_embed.seq.*``,
``image_encoder.layers.*``, ``image_encoder.neck.*``): a Conv2d+BN stem
(stride 4), an MBConv stage (2 blocks, GELU, residual), three windowed
attention stages (depths 2 / 6 / 2, heads 4 / 5 / 10, windows 7 / 14 / 7)
whose qkv is packed per head and whose attention biases are gathered by
|Δ| offsets in the reference's insertion order, a depthwise local conv
between attention and MLP, Conv2d+BN patch merging (stride 1 into the
320-d stage, so the grid stays at S / 16) and the SAM neck. ``fold()``
folds every Conv2d_BN in numpy, as the JAX converter does.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pcdms_tpu_torch.pose.detectors.common import fold_conv_bn

EMBED_DIMS = (64, 128, 160, 320)
DEPTHS = (2, 2, 6, 2)
NUM_HEADS = (2, 4, 5, 10)
WINDOWS = (7, 7, 14, 7)
MBCONV_EXPAND = 4
MLP_RATIO = 4


class Conv2d_BN(nn.Module):
    """A bias-free conv (``c``) and its BatchNorm (``bn``); ``fold()``
    turns them into one biased conv."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 pad: int = 0, groups: int = 1):
        super().__init__()
        self.c = nn.Conv2d(cin, cout, k, stride, pad, groups=groups,
                           bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return self.bn(self.c(x))

    def fold(self) -> None:
        if not isinstance(self.bn, nn.Identity):
            fold_conv_bn(self.c, self.bn)
            self.bn = nn.Identity()


@functools.lru_cache(maxsize=8)
def attention_bias_idxs(h: int, w: int) -> np.ndarray:
    """(N, N) indices into the unique |Δ| offsets, numbered in the
    reference's insertion order."""
    points = list(itertools.product(range(h), range(w)))
    offsets: Dict[Tuple[int, int], int] = {}
    idxs = []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    n = len(points)
    return np.asarray(idxs, np.int64).reshape(n, n)


class Attention(nn.Module):
    """Windowed tokens (B*, N, C) -> same: LayerNorm, qkv packed per head
    (the linear's output splits into (heads, 3 hd) and [q, k, v] within
    each head's slice), the learned bias of each |Δ| offset."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        n_off = int(attention_bias_idxs(window, window).max()) + 1
        self.norm = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.attention_biases = nn.Parameter(torch.zeros(heads, n_off))

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(self.norm(x)).reshape(b, n, self.heads, 3 * hd)
        q, k, v = (z.transpose(1, 2) for z in qkv.split(hd, -1))
        idx = torch.from_numpy(attention_bias_idxs(
            self.window, self.window)).to(x.device)
        attn = (q @ k.transpose(2, 3)) / math.sqrt(hd)
        attn = torch.softmax(attn + self.attention_biases[:, idx][None], -1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(self.norm(x))))


class TinyViTBlock(nn.Module):
    """Windowed attention (the grid zero-padded to whole windows and
    cropped back), the depthwise local conv, the MLP; residual."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.window = window
        self.attn = Attention(dim, heads, window)
        self.local_conv = Conv2d_BN(dim, dim, 3, 1, 1, groups=dim)
        self.mlp = Mlp(dim, dim * MLP_RATIO)

    def forward(self, x, hw: Tuple[int, int]):
        hh, ww = hw
        b, l, c = x.shape
        ws = self.window
        if (hh, ww) == (ws, ws):
            h = self.attn(x)
        else:
            h = x.reshape(b, hh, ww, c)
            pad_b, pad_r = (ws - hh % ws) % ws, (ws - ww % ws) % ws
            if pad_b or pad_r:
                h = F.pad(h, (0, 0, 0, pad_r, 0, pad_b))
            ph, pw = hh + pad_b, ww + pad_r
            nh, nw = ph // ws, pw // ws
            h = (h.reshape(b, nh, ws, nw, ws, c).transpose(2, 3)
                 .reshape(b * nh * nw, ws * ws, c))
            h = self.attn(h)
            h = (h.reshape(b, nh, nw, ws, ws, c).transpose(2, 3)
                 .reshape(b, ph, pw, c))[:, :hh, :ww].reshape(b, l, c)
        x = x + h
        x = self.local_conv(x.transpose(1, 2).reshape(b, c, hh, ww))
        x = x.flatten(2).transpose(1, 2)
        return x + self.mlp(x)


class MBConv(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        hid = c * MBCONV_EXPAND
        self.conv1 = Conv2d_BN(c, hid, 1)
        self.conv2 = Conv2d_BN(hid, hid, 3, 1, 1, groups=hid)
        self.conv3 = Conv2d_BN(hid, c, 1)

    def forward(self, x):
        h = F.gelu(self.conv1(x))
        h = self.conv3(F.gelu(self.conv2(h)))
        return F.gelu(h + x)


class PatchMerging(nn.Module):
    """1x1, depthwise 3x3 (stride 2, or 1 into the 320-d stage), 1x1."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        stride = 1 if cout in (320, 448, 576) else 2
        self.conv1 = Conv2d_BN(cin, cout, 1)
        self.conv2 = Conv2d_BN(cout, cout, 3, stride, 1, groups=cout)
        self.conv3 = Conv2d_BN(cout, cout, 1)

    def forward(self, x):
        h = F.gelu(self.conv1(x))
        return self.conv3(F.gelu(self.conv2(h)))


class Stage(nn.Module):
    """``layers.{i}``: the blocks and, but for the last, the merge."""

    def __init__(self, si: int):
        super().__init__()
        dim = EMBED_DIMS[si]
        self.blocks = nn.ModuleList(
            [MBConv(dim) if si == 0 else
             TinyViTBlock(dim, NUM_HEADS[si], WINDOWS[si])
             for _ in range(DEPTHS[si])])
        if si < 3:
            self.downsample = PatchMerging(dim, EMBED_DIMS[si + 1])

    def forward(self, x):
        if isinstance(self.blocks[0], MBConv):
            for blk in self.blocks:
                x = blk(x)
        else:
            b, c, hh, ww = x.shape
            tokens = x.flatten(2).transpose(1, 2)
            for blk in self.blocks:
                tokens = blk(tokens, (hh, ww))
            x = tokens.transpose(1, 2).reshape(b, c, hh, ww)
        return self.downsample(x) if hasattr(self, "downsample") else x


class PatchEmbed(nn.Module):
    def __init__(self):
        super().__init__()
        d0 = EMBED_DIMS[0]
        self.seq = nn.Sequential(Conv2d_BN(3, d0 // 2, 3, 2, 1), nn.GELU(),
                                 Conv2d_BN(d0 // 2, d0, 3, 2, 1))


class TinyViT(nn.Module):
    """(B, 3, S, S) pixel-normalised -> (B, 256, S / 16, S / 16)."""

    def __init__(self):
        super().__init__()
        from pcdms_tpu_torch.pose.detectors.sam import neck
        self.patch_embed = PatchEmbed()
        self.layers = nn.ModuleList([Stage(si) for si in range(4)])
        self.neck = neck(EMBED_DIMS[-1])

    def fold(self) -> "TinyViT":
        """Every Conv2d_BN folded (in place) -> self."""
        for m in self.modules():
            if isinstance(m, Conv2d_BN):
                m.fold()
        return self

    def forward(self, x):
        seq = self.patch_embed.seq
        h = seq[2](F.gelu(seq[0](x)))
        for stage in self.layers:
            h = stage(h)
        return self.neck(h)
