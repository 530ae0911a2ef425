"""ZoeDepth metric-depth detector (DPT-BEiT-L-384 + metric bins) as an
``nn.Module``, NCHW (counterpart of ``pcdms_tpu/pose/detectors/zoe.py``).

controlnet-aux ``zoe``'s ``ZoeD_M12_N`` under the published key names of
``ZoeD_M12_N.pt`` (``core.core.pretrained.model.*``: BEiT-L/16, 24 pre-LN
blocks, q / v-only qkv bias, a decomposed relative position bias per block
whose table is resized to the window, with the reference's transposed
(width, height) reshape of the table, gamma layer scale;
``core.core.pretrained.act_postprocess*``: project-readout reassembly with
transposed-conv x4 / x2 for the shallow hooks; ``core.core.scratch.*``: the
DPT fusion and head; and the metric head: ``conv2``, the seed bin
regressor and projector, four projectors and inverse attractors, the
conditional log-binomial). BEiT's attention is plain
``softmax(q k^T / sqrt(d) + bias) v``.

``ZoeDetector.infer`` is DepthModel.infer: reflect padding, the
aspect-kept 'minimal' multiple-of-32 resize, the flip average and the
bicubic way back; ``__call__`` normalises by the 2nd / 85th percentiles
(numpy's linear method) and inverts.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pcdms_tpu_torch.pose import imgproc
from pcdms_tpu_torch.pose.detectors.common import (
    as_image, hwc3, resize_to_64, shape_to_64,
)
from pcdms_tpu_torch.pose.detectors.midas import (
    Mlp, ProjectReadout, Scratch, linear_resize, resize_align_corners,
    tokens_to_map,
)

DIM = 1024
HEADS = 16
DEPTH = 24
HOOKS = (5, 11, 17, 23)
FEATURES = (256, 512, 1024, 1024)
ORIG_WINDOW = 24                     # 384 / 16
N_BINS = 64
BIN_EMBED = 128
N_ATTRACTORS = (16, 8, 4, 1)
ALPHA = 1000.0
GAMMA = 2
MIN_TEMP = 0.0212
MAX_TEMP = 50.0


# ---------------------------------------------------------------------------
# the BEiT trunk
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def rel_pos_index(wh: int, ww: int) -> np.ndarray:
    """timm ``gen_relative_position_index``: (N + 1, N + 1) indices into the
    table, its 3 cls-relation slots last."""
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    n = wh * ww
    idx = np.zeros((n + 1, n + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, :] = num_rel - 3
    idx[:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx


def rel_pos_bias(table: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """The (2 * 24 - 1)^2 + 3 table resized to a (wh, ww) window and
    gathered -> (heads, N + 1, N + 1). As the reference, the old square
    table is read as (width, height) before its resize to (new height, new
    width); the resize is ``linear_resize``, the JAX package's."""
    old = 2 * ORIG_WINDOW - 1
    nh, nw = 2 * wh - 1, 2 * ww - 1
    heads = table.shape[-1]
    sub = table[:old * old]
    if (nh, nw) != (old, old):
        grid = sub.reshape(old, old, heads).permute(2, 0, 1)
        sub = linear_resize(grid, nh, nw).permute(1, 2, 0).reshape(
            nh * nw, heads)
    new_table = torch.cat([sub, table[old * old:]], 0)
    idx = torch.from_numpy(rel_pos_index(wh, ww)).to(table.device)
    return new_table[idx.reshape(-1)].reshape(
        idx.shape[0], idx.shape[1], heads).permute(2, 0, 1)


class BeitAttention(nn.Module):
    def __init__(self, dim=DIM, heads=HEADS):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * ORIG_WINDOW - 1) ** 2 + 3, heads))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, window):
        b, t, c = x.shape
        hd = c // self.heads
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias])
        q, k, v = F.linear(x, self.qkv.weight, bias).reshape(
            b, t, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        attn = (q / math.sqrt(hd)) @ k.transpose(-2, -1)
        attn = attn + rel_pos_bias(self.relative_position_bias_table,
                                   *window)[None]
        return self.proj((attn.softmax(-1) @ v).transpose(1, 2).reshape(
            b, t, c))


class BeitBlock(nn.Module):
    def __init__(self, dim=DIM):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = BeitAttention(dim)
        self.gamma_1 = nn.Parameter(torch.zeros(dim))
        self.gamma_2 = nn.Parameter(torch.zeros(dim))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x, window):
        x = x + self.gamma_1 * self.attn(self.norm1(x), window)
        return x + self.gamma_2 * self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = nn.Conv2d(3, DIM, 16, stride=16)


class Beit(nn.Module):
    def __init__(self):
        super().__init__()
        self.patch_embed = PatchEmbed()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, DIM))
        self.blocks = nn.ModuleList([BeitBlock() for _ in range(DEPTH)])

    def forward(self, x):
        """-> the four hooks' tokens (B, N + 1, 1024)."""
        b, _, h, w = x.shape
        window = (h // 16, w // 16)
        tokens = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], 1)
        hooks = []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens, window)
            if i in HOOKS:
                hooks.append(tokens)
        return hooks


class BeitPretrained(nn.Module):
    def __init__(self):
        super().__init__()
        self.model = Beit()
        f = FEATURES

        def post(i, *extra):
            return nn.Sequential(ProjectReadout(DIM), nn.Identity(),
                                 nn.Identity(), nn.Conv2d(DIM, f[i], 1),
                                 *extra)
        self.act_postprocess1 = post(0, nn.ConvTranspose2d(f[0], f[0], 4, 4))
        self.act_postprocess2 = post(1, nn.ConvTranspose2d(f[1], f[1], 2, 2))
        self.act_postprocess3 = post(2)
        self.act_postprocess4 = post(3, nn.Conv2d(f[3], f[3], 3, 2, 1))


class DPTBeit(nn.Module):
    """x: (B, 3, H, W) 0.5 / 0.5-normalised -> (rel depth (B, H, W), the
    32-channel head activation, layer4_rn, [r4, r3, r2, r1])."""

    def __init__(self):
        super().__init__()
        self.pretrained = BeitPretrained()
        self.scratch = Scratch(FEATURES)

    def forward(self, x):
        gs_h, gs_w = x.shape[2] // 16, x.shape[3] // 16
        hooks = self.pretrained.model(x)
        layers = []
        for i, tok in enumerate(hooks, 1):
            pp = getattr(self.pretrained, f"act_postprocess{i}")
            h = tokens_to_map(pp[0](tok), gs_h, gs_w)
            for m in pp[3:]:
                h = m(h)
            layers.append(h)
        l4_rn, blocks = self.scratch.fuse(layers)
        act, rel = self.scratch.head(blocks[3])
        return rel, act, l4_rn, blocks


class DepthCore(nn.Module):
    def __init__(self):
        super().__init__()
        self.core = DPTBeit()


def _mlp2(cin, mid, cout, act=nn.ReLU, last=None):
    layers = [nn.Conv2d(cin, mid, 1), act(), nn.Conv2d(mid, cout, 1)]
    return nn.Sequential(*(layers + ([last] if last is not None else [])))


class Net(nn.Module):
    """A named ``_net`` Sequential (the reference's projector, regressor
    and attractor modules)."""

    def __init__(self, cin, mid, cout, softplus):
        super().__init__()
        self._net = _mlp2(cin, mid, cout,
                          last=nn.Softplus() if softplus else None)

    def forward(self, x):
        return self._net(x)


class ConditionalLogBinomial(nn.Module):
    def __init__(self, cin=32 + 1, cond=BIN_EMBED):
        super().__init__()
        total = cin + cond
        self.mlp = _mlp2(total, total // 2, 4, act=nn.GELU,
                         last=nn.Softplus())

    def forward(self, x, cond):
        pt = self.mlp(torch.cat([x, cond], 1))
        eps = 1e-4
        pp = pt[:, 0:2] + eps
        prob = pp[:, 0:1] / (pp[:, 0:1] + pp[:, 1:2])
        tt = pt[:, 2:4] + eps
        t = tt[:, 0:1] / (tt[:, 0:1] + tt[:, 1:2])
        t = (MAX_TEMP - MIN_TEMP) * t + MIN_TEMP
        return log_binomial(prob, t, N_BINS)


def log_binomial(p, t, n_classes: int):
    """LogBinomial over (B, 1, H, W) probability / temperature maps ->
    (B, n_classes, H, W) probabilities."""
    eps = 1e-4
    k = torch.arange(n_classes, dtype=p.dtype, device=p.device)[
        None, :, None, None]
    big_k = float(n_classes - 1)

    def log_binom(n, kk, e=1e-7):
        n = n + e
        kk = kk + e
        return (n * torch.log(n) - kk * torch.log(kk)
                - (n - kk) * torch.log(n - kk + e))

    x = p.clamp(eps, 1.0)
    one_minus = (1.0 - p).clamp(eps, 1.0)
    y = (log_binom(torch.tensor(big_k, dtype=p.dtype, device=p.device), k)
         + k * torch.log(x) + (big_k - k) * torch.log(one_minus))
    return torch.softmax(y / t, 1)


class ZoeDepth(nn.Module):
    """x: (B, 3, H, W) in [0, 1], H and W multiples of 32 -> (B, H, W)
    metric depth."""

    def __init__(self):
        super().__init__()
        self.core = DepthCore()
        self.conv2 = nn.Conv2d(256, 256, 1)
        self.seed_bin_regressor = Net(256, 256, N_BINS, softplus=True)
        self.seed_projector = Net(256, 128, BIN_EMBED, softplus=False)
        self.projectors = nn.ModuleList([
            Net(256, 128, BIN_EMBED, softplus=False) for _ in range(4)])
        self.attractors = nn.ModuleList([
            Net(BIN_EMBED, 128, n, softplus=True) for n in N_ATTRACTORS])
        self.conditional_log_binomial = ConditionalLogBinomial()

    def forward(self, x):
        x = (x - 0.5) / 0.5
        rel, act, l4_rn, blocks = self.core.core(x)
        x_d0 = self.conv2(l4_rn)
        b_prev = self.seed_bin_regressor(x_d0)
        prev_emb = self.seed_projector(x_d0)
        for proj, attr, feat in zip(self.projectors, self.attractors, blocks):
            emb = proj(feat)
            h, w = emb.shape[2:]
            a = attr(emb + resize_align_corners(prev_emb, h, w))
            centers = resize_align_corners(b_prev, h, w)
            dx = a[:, :, None] - centers[:, None]
            b_prev = centers + (dx / (1.0 + ALPHA * dx ** GAMMA)).mean(1)
            prev_emb = emb
        lh, lw = act.shape[2:]
        last = torch.cat([act, resize_align_corners(rel[:, None], lh, lw)], 1)
        probs = self.conditional_log_binomial(
            last, resize_align_corners(prev_emb, lh, lw))
        return (probs * resize_align_corners(b_prev, lh, lw)).sum(1)


def prep_size(h: int, w: int, net_h: int = 384,
              net_w: int = 512) -> Tuple[int, int]:
    """The network's input size for an (h, w) image: aspect kept, the
    'minimal' scale, multiples of 32 (base_models/midas.py:100-172)."""
    scale_h, scale_w = net_h / h, net_w / w
    if abs(1 - scale_w) < abs(1 - scale_h):
        scale_h = scale_w
    else:
        scale_w = scale_h
    return (int(np.round(scale_h * h / 32) * 32),
            int(np.round(scale_w * w / 32) * 32))


def percentile(x: torch.Tensor, q: float) -> np.float32:
    """``np.percentile(x, q)`` (the linear method) of an f32 tensor on any
    device: its values sorted there, the two neighbours of rank
    ``q / 100 * (n - 1)`` (in the map's f32, as numpy keeps the input's
    dtype) interpolated in f32 as numpy's ``_lerp`` does."""
    flat = x.reshape(-1).sort().values
    n = flat.numel()
    rank = np.float32(q / 100.0) * np.float32(n - 1)
    lo = int(np.floor(rank))
    t = np.float32(rank - np.float32(lo))
    a, b = flat[[lo, min(lo + 1, n - 1)]].cpu().numpy()
    diff = b - a
    return b - diff * (np.float32(1) - t) if t >= 0.5 else a + diff * t


class ZoeDetector:
    """zoe/__init__.py's call protocol on the port's network, on ``device``
    (None: CUDA), in f32 with TF32 off: metric depth -> the percentile 2 /
    85 normalised, inverted uint8 map."""

    def __init__(self, model: ZoeDepth, device=None):
        from pcdms_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_pretrained(cls, weights_path: str, device=None):
        """From ``ZoeD_M12_N.pt`` (its ``model`` dict where there is one,
        ``module.`` taken off; unpickled: trusted local files only)."""
        from pcdms_tpu_torch.pose.detectors.common import empty, load_network
        return cls(load_network(empty(ZoeDepth), weights_path),
                   device)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        from pcdms_tpu_torch.pose.dwpose import f32_forward
        with f32_forward():
            return self.model(x.permute(2, 0, 1)[None])[0]

    @torch.no_grad()
    def infer(self, rgb01: torch.Tensor, pad_input: bool = True,
              with_flip_aug: bool = True) -> torch.Tensor:
        """DepthModel.infer on an (H, W, 3) f32 [0, 1] tensor -> (H, W)
        f32 depth."""
        def run_once(img):
            h, w = img.shape[:2]
            if pad_input:
                pad_h = int(np.sqrt(h / 2) * 3)
                pad_w = int(np.sqrt(w / 2) * 3)
                img = F.pad(img.permute(2, 0, 1)[None],
                            (pad_w, pad_w, pad_h, pad_h),
                            mode="reflect")[0].permute(1, 2, 0)
            ph, pw = img.shape[:2]
            nh, nw = prep_size(ph, pw)
            x = imgproc.resize(img.contiguous(), (nw, nh),
                               "area" if nh < ph else "linear")
            depth = imgproc.resize(self._forward(x), (pw, ph), "cubic")
            if pad_input:
                depth = depth[pad_h:ph - pad_h, pad_w:pw - pad_w]
            return depth

        out = run_once(rgb01)
        if with_flip_aug:
            out = (out + run_once(rgb01.flip(1)).flip(1)) / 2.0
        return out

    @torch.no_grad()
    def __call__(self, input_image, detect_resolution: int = 512,
                 image_resolution: int = 512,
                 gamma_corrected: bool = False) -> np.ndarray:
        img = hwc3(as_image(input_image, self.device))
        img = resize_to_64(img, detect_resolution)
        depth = self.infer(img.float() / 255.0)
        vmin, vmax = percentile(depth, 2), percentile(depth, 85)
        depth = (depth - float(vmin)) / float(max(vmax - vmin, 1e-12))
        depth = 1.0 - depth
        if gamma_corrected:
            depth = depth ** 2.2
        depth = torch.nan_to_num(depth, nan=0.0, posinf=1.0, neginf=0.0)
        detected = hwc3((depth * 255.0).clamp(0, 255).to(torch.uint8))
        out_hw = shape_to_64(*img.shape[:2], image_resolution)
        return imgproc.resize(detected, (out_hw[1], out_hw[0]),
                              "linear").cpu().numpy()
