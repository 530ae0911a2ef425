"""Plain PyTorch networks of the benchmark's reference: the SD-2.1 UNet
(stage-2 and stage-3 variants), the SD VAE, the DINOv2-feature projection
and the pose encoder, under the diffusers / PCDMs state-dict names.

A frozen copy of the published architectures, written from the diffusers
equations and independent of the program under test: float32 throughout,
GroupNorm and LayerNorm by ``torch.nn.functional``, attention as plain
softmax(q k^T / sqrt(d)) v computed in blocks of (batch x head) so that
8192 tokens fit on the card. Tensors are NHWC at the public functions, as
the program's are.

``set_precision(module, "fp8")`` turns the module into the correctness
control: every convolution and linear layer rounds its input and its weight
to float8 e4m3 (per-tensor scale) before an f32 product, the nearest
precision below the bfloat16 that the configurations state.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

_FP8_MAX = 448.0
# score bytes a block of the plain attention may take
_ATTN_BLOCK_BYTES = 1 << 30


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    amax = x.abs().max().clamp(min=1e-12)
    scale = amax / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Quant(nn.Module):
    fp8 = False

    def _operands(self, x, w):
        if self.fp8:
            return fp8_round(x.float()), fp8_round(w.float())
        return x.float(), w.float()


class Linear(_Quant):
    def __init__(self, fan_in: int, fan_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fan_out, fan_in))
        self.bias = nn.Parameter(torch.empty(fan_out)) if bias else None

    def forward(self, x):
        x, w = self._operands(x, self.weight)
        return F.linear(x, w, None if self.bias is None
                        else self.bias.float())


class Conv2d(_Quant):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        x, w = self._operands(x, self.weight)
        return F.conv2d(x, w, self.bias.float(), self.stride, self.padding)


class GroupNorm(nn.Module):
    def __init__(self, groups: int, ch: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.empty(ch))
        self.bias = nn.Parameter(torch.empty(ch))

    def forward(self, x):
        return F.group_norm(x.float(), self.groups, self.weight.float(),
                            self.bias.float(), self.eps)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            self.bias.float(), self.eps)


def plain_attention(q, k, v, heads: int):
    """softmax(q k^T / sqrt(d)) v on packed (B, L, H*D) f32 tensors, in
    blocks of (batch x head) rows so the scores stay under 1 GiB."""
    b, lq, hd = q.shape
    lk, d = k.shape[1], hd // heads
    qh = q.reshape(b, lq, heads, d).transpose(1, 2).reshape(b * heads, lq, d)
    kh = k.reshape(b, lk, heads, d).transpose(1, 2).reshape(b * heads, lk, d)
    vh = v.reshape(b, lk, heads, d).transpose(1, 2).reshape(b * heads, lk, d)
    step = max(1, _ATTN_BLOCK_BYTES // (lq * lk * 4))
    out = torch.empty_like(qh)
    for i in range(0, b * heads, step):
        s = torch.bmm(qh[i:i + step], kh[i:i + step].transpose(1, 2))
        p = torch.softmax(s / math.sqrt(d), dim=-1)
        out[i:i + step] = torch.bmm(p, vh[i:i + step])
    return out.reshape(b, heads, lq, d).transpose(1, 2).reshape(b, lq, hd)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, ctx_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        ctx_dim = ctx_dim or dim
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(ctx_dim, dim, bias=False)
        self.to_v = Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        o = plain_attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                            self.heads)
        return self.to_out[0](o)


class _GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([_GEGLU(dim, 4 * dim), nn.Identity(),
                                  Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ctx_dim: int):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = (LayerNorm(dim), LayerNorm(dim),
                                              LayerNorm(dim))
        self.attn1 = Attention(dim, heads)
        self.attn2 = Attention(dim, heads, ctx_dim)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, ch: int, head_dim: int, ctx_dim: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(groups, ch, 1e-6)
        self.proj_in = Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, ch // head_dim, ctx_dim)])
        self.proj_out = Linear(ch, ch)

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        t = self.proj_out(self.transformer_blocks[0](t, ctx))
        return t.transpose(1, 2).reshape(b, c, h, w) + x


class Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int],
                 groups: int, eps: float):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        if temb is not None:
            self.time_emb_proj = Linear(temb, cout)
        self.norm2 = GroupNorm(groups, cout, eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class _ConvHolder(nn.Module):
    def __init__(self, ch: int, stride: int, padding: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=stride, padding=padding)


class _Block(nn.Module):
    """A UNet down / up block or a VAE block: resnets, optional
    attentions, optional down- or up-sampler."""

    def __init__(self, chans: Sequence[tuple], temb, groups, eps,
                 attn: Optional[tuple] = None, down: Optional[int] = None,
                 up: bool = False, pad: int = 1):
        super().__init__()
        self.resnets = nn.ModuleList(
            [Resnet(cin, cout, temb, groups, eps) for cin, cout in chans])
        if attn is not None:
            head_dim, ctx_dim = attn
            self.attentions = nn.ModuleList([
                Transformer2D(cout, head_dim, ctx_dim, groups)
                for _, cout in chans])
        out = chans[-1][1]
        if down is not None:
            self.downsamplers = nn.ModuleList([_ConvHolder(out, 2, pad)])
        if up:
            self.upsamplers = nn.ModuleList([_ConvHolder(out, 1, 1)])


def sinusoid(t, dim: int):
    """diffusers ``Timesteps(dim, flip_sin_to_cos=True, shift=0)``."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    e = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(e), torch.sin(e)], dim=-1)


class _TimeEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(cin, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class UNet(nn.Module):
    """SD-2.1 ``UNet2DConditionModel`` as PCDMs uses it: ``in_channels``
    9 (stage 2) or 8 (stage 3), an optional class embedding of the target
    CLIP embedding, an optional pose map added after ``conv_in``."""

    def __init__(self, cfg: dict):
        super().__init__()
        ch = cfg["block_out_channels"]
        n, g = len(ch), cfg["norm_groups"]
        lpb, hd, cd = (cfg["layers_per_block"], cfg["attention_head_dim"],
                       cfg["cross_attention_dim"])
        cross = cfg["cross_attn_down"]
        temb = 4 * ch[0]
        self.time_embedding = _TimeEmbedding(ch[0], temb)
        if cfg.get("class_embed_proj_dim"):
            self.class_embedding = _TimeEmbedding(cfg["class_embed_proj_dim"],
                                                  temb)
        self.conv_in = Conv2d(cfg["in_channels"], ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cin = ch[0]
        for i, cout in enumerate(ch):
            chans = [(cin if j == 0 else cout, cout) for j in range(lpb)]
            self.down_blocks.append(_Block(
                chans, temb, g, 1e-5, attn=(hd, cd) if cross[i] else None,
                down=1 if i < n - 1 else None))
            cin = cout
        self.mid_block = _Block([(ch[-1], ch[-1])] * 2, temb, g, 1e-5)
        self.mid_block.attentions = nn.ModuleList(
            [Transformer2D(ch[-1], hd, cd, g)])
        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i in range(n):
            skip_ch = rev[min(i + 1, n - 1)]
            chans = [((prev if j == 0 else rev[i])
                      + (skip_ch if j == lpb else rev[i]), rev[i])
                     for j in range(lpb + 1)]
            self.up_blocks.append(_Block(
                chans, temb, g, 1e-5,
                attn=(hd, cd) if cross[n - 1 - i] else None, up=i < n - 1))
            prev = rev[i]
        self.conv_norm_out = GroupNorm(g, ch[0], 1e-5)
        self.conv_out = Conv2d(ch[0], cfg["out_channels"], 3, padding=1)

    def forward(self, sample, t, ctx, class_labels=None, pose=None):
        emb = self.time_embedding(sinusoid(t, self.conv_in.weight.shape[0]))
        if hasattr(self, "class_embedding"):
            emb = emb + self.class_embedding(class_labels)
        x = self.conv_in(sample.permute(0, 3, 1, 2))
        if pose is not None:
            x = x + pose.permute(0, 3, 1, 2).float()
        skips = [x]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                x = res(x, emb)
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, ctx)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0].conv(x)
                skips.append(x)
        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x, emb), ctx),
                           emb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), emb)
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, ctx)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(
                    F.interpolate(x, scale_factor=2.0, mode="nearest"))
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.permute(0, 2, 3, 1)


class VAEAttention(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, 1e-6)
        self.to_q, self.to_k, self.to_v = (Linear(ch, ch), Linear(ch, ch),
                                           Linear(ch, ch))
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.group_norm(x).flatten(2).transpose(1, 2)
        o = plain_attention(self.to_q(t), self.to_k(t), self.to_v(t), 1)
        return x + self.to_out[0](o).transpose(1, 2).reshape(b, c, h, w)


class _VAEMid(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [Resnet(ch, ch, None, groups, 1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAE(nn.Module):
    """SD ``AutoencoderKL``: encode to the posterior mean (scaled), decode
    scaled latents."""

    def __init__(self, cfg: dict):
        super().__init__()
        ch, g, lpb = (cfg["block_out_channels"], cfg["norm_groups"],
                      cfg["layers_per_block"])
        lat = cfg["latent_channels"]
        self.scaling = cfg["scaling_factor"]
        enc = nn.Module()
        enc.conv_in = Conv2d(cfg["in_channels"], ch[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        cin = ch[0]
        for i, cout in enumerate(ch):
            enc.down_blocks.append(_Block(
                [(cin if j == 0 else cout, cout) for j in range(lpb)], None,
                g, 1e-6, down=1 if i < len(ch) - 1 else None, pad=0))
            cin = cout
        enc.mid_block = _VAEMid(ch[-1], g)
        enc.conv_norm_out = GroupNorm(g, ch[-1], 1e-6)
        enc.conv_out = Conv2d(ch[-1], 2 * lat, 3, padding=1)
        self.encoder = enc
        rev = list(reversed(ch))
        dec = nn.Module()
        dec.conv_in = Conv2d(lat, rev[0], 3, padding=1)
        dec.mid_block = _VAEMid(rev[0], g)
        dec.up_blocks = nn.ModuleList()
        cin = rev[0]
        for i, cout in enumerate(rev):
            dec.up_blocks.append(_Block(
                [(cin if j == 0 else cout, cout) for j in range(lpb + 1)],
                None, g, 1e-6, up=i < len(rev) - 1))
            cin = cout
        dec.conv_norm_out = GroupNorm(g, rev[-1], 1e-6)
        dec.conv_out = Conv2d(rev[-1], cfg["in_channels"], 3, padding=1)
        self.decoder = dec
        self.quant_conv = Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = Conv2d(lat, lat, 1)

    def encode_mean(self, image):
        """(B, H, W, 3) in [-1, 1] -> scaled posterior mean (B, H/8, W/8,
        4)."""
        return self.encode_moments(image)[0] * self.scaling

    def encode_moments(self, image):
        """Unscaled posterior mean and log-variance (clipped to [-30, 20]),
        (B, H/8, W/8, 4) each."""
        e = self.encoder
        h = e.conv_in(image.permute(0, 3, 1, 2))
        for blk in e.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = e.conv_out(F.silu(e.conv_norm_out(e.mid_block(h))))
        mean, logvar = self.quant_conv(h).permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z):
        d = self.decoder
        h = self.post_quant_conv(z.permute(0, 3, 1, 2) / self.scaling)
        h = d.mid_block(d.conv_in(h))
        for blk in d.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(
                    F.interpolate(h, scale_factor=2.0, mode="nearest"))
        h = d.conv_out(F.silu(d.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1)


class ImageProj(nn.Module):
    """PCDMs ``ImageProjModel_p``: Linear -> GELU -> (Dropout) ->
    LayerNorm -> Linear."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.net = nn.ModuleList([
            Linear(cfg["in_dim"], cfg["hidden_dim"]), nn.Identity(),
            nn.Identity(), LayerNorm(cfg["hidden_dim"]),
            Linear(cfg["hidden_dim"], cfg["out_dim"])])

    def forward(self, x):
        return self.net[4](self.net[3](F.gelu(self.net[0](x))))


class PoseEncoder(nn.Module):
    """diffusers ``ControlNetConditioningEmbedding``: (B, H, W, 3) ->
    (B, H/8, W/8, out_channels)."""

    def __init__(self, cfg: dict):
        super().__init__()
        ch = cfg["block_out_channels"]
        self.conv_in = Conv2d(3, ch[0], 3, padding=1)
        blocks = []
        for a, b in zip(ch[:-1], ch[1:]):
            blocks += [Conv2d(a, a, 3, padding=1),
                       Conv2d(a, b, 3, stride=2, padding=1)]
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = Conv2d(ch[-1], cfg["out_channels"], 3, padding=1)

    def forward(self, x):
        h = F.silu(self.conv_in(x.permute(0, 3, 1, 2)))
        for blk in self.blocks:
            h = F.silu(blk(h))
        return self.conv_out(h).permute(0, 2, 3, 1)


NETS = {"unet": UNet, "vae": VAE, "image_proj": ImageProj,
        "pose_proj": PoseEncoder}


def set_precision(module: nn.Module, precision: str) -> nn.Module:
    """"f32" (the reference) or "fp8" (the control) for every linear and
    convolution of ``module``."""
    if precision not in ("f32", "fp8"):
        raise ValueError(precision)
    for m in module.modules():
        if isinstance(m, _Quant):
            m.fp8 = precision == "fp8"
    return module
