"""SD-2.1 UNet building blocks (counterpart of
``pcdms_tpu/nn/unet_blocks.py``), NCHW inside, diffusers state-dict names:
ResnetBlock2D, Transformer2DModel (linear projections), Down/Upsample2D,
CrossAttn{Down,Up}Block2D / {Down,Up}Block2D, UNetMidBlock2DCrossAttn.
``fused_conv=True`` runs each resnet conv through the fused GroupNorm +
SiLU + conv3x3 kernel (``ops/fused_conv.py``), as the JAX blocks' flag does.
``freeu=(s, b)`` applies FreeU in an up block: the backbone's first half of
channels scaled by b, the skip's low frequencies by s (``fourier_filter``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from pcdms_tpu_torch.nn.layers import (
    Conv2d, GroupNorm, Linear, silu, upsample2x_conv3x3,
)
from pcdms_tpu_torch.nn.transformer import BasicTransformerBlock
from pcdms_tpu_torch.ops.fused_conv import gn_silu_conv3x3


class ResnetBlock2D(nn.Module):
    """GroupNorm -> SiLU -> conv3x3 (+ temb) -> GroupNorm -> SiLU -> conv3x3,
    plus the (1x1-projected) shortcut; ``fused=True`` runs each
    GroupNorm -> SiLU -> conv3x3 as one fused-conv call, the time embedding
    and the shortcut added in its epilogue."""

    def __init__(self, in_ch: int, out_ch: int,
                 temb_dim: Optional[int] = None, groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, eps)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = Linear(temb_dim, out_ch)
        self.norm2 = GroupNorm(groups, out_ch, eps)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = Conv2d(in_ch, out_ch, 1)

    def forward(self, x, temb=None, fused: bool = False):
        t = None
        if temb is not None and hasattr(self, "time_emb_proj"):
            t = self.time_emb_proj(silu(temb))
        if fused:
            h = self._gn_silu_conv(x, self.norm1, self.conv1, temb=t)
            shortcut = (self.conv_shortcut(x)
                        if hasattr(self, "conv_shortcut") else x)
            return self._gn_silu_conv(h, self.norm2, self.conv2,
                                      residual=shortcut)
        h = self.conv1(silu(self.norm1(x)))
        if t is not None:
            h = h + t[:, :, None, None]
        h = self.conv2(silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h

    @staticmethod
    def _gn_silu_conv(x, norm, conv, **extra):
        return gn_silu_conv3x3(x, norm.weight, norm.bias, conv.weight,
                               conv.bias, num_groups=norm.num_groups,
                               eps=norm.eps, **extra)


class Transformer2DModel(nn.Module):
    """Spatial transformer: GroupNorm(eps 1e-6) -> proj_in -> blocks ->
    proj_out, plus the residual, over the (H*W) tokens."""

    def __init__(self, ch: int, heads: int, head_dim: int, context_dim: int,
                 depth: int = 1, groups: int = 32):
        super().__init__()
        self.norm = GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(ch, heads, head_dim,
                                  context_dim=context_dim, geglu=True)
            for _ in range(depth)])
        self.proj_out = Linear(ch, ch)

    def forward(self, x, context, use_flash: bool = True,
                zero_ctx_prefix: int = 0):
        b, c, h, w = x.shape
        tokens = self.norm(x).flatten(2).transpose(1, 2)          # (B, HW, C)
        tokens = self.proj_in(tokens)
        for block in self.transformer_blocks:
            tokens = block(tokens, context, use_flash=use_flash,
                           zero_ctx_prefix=zero_ctx_prefix)
        tokens = self.proj_out(tokens)
        return tokens.transpose(1, 2).reshape(b, c, h, w) + x


class Downsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return upsample2x_conv3x3(self.conv, x)


class DownBlock(nn.Module):
    """CrossAttnDownBlock2D (cross_attn=True) or DownBlock2D."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: int,
                 num_layers: int, *, cross_attn: bool, context_dim: int,
                 head_dim: int, add_downsample: bool, groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, temb_dim,
                          groups)
            for i in range(num_layers)])
        if cross_attn:
            self.attentions = nn.ModuleList([
                Transformer2DModel(out_ch, out_ch // head_dim, head_dim,
                                   context_dim, groups=groups)
                for _ in range(num_layers)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(out_ch)])

    def forward(self, x, temb, context, use_flash: bool = True,
                zero_ctx_prefix: int = 0, fused_conv: bool = False):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb, fused=fused_conv)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context, use_flash=use_flash,
                                       zero_ctx_prefix=zero_ctx_prefix)
            skips.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class MidBlock(nn.Module):
    """UNetMidBlock2DCrossAttn: resnet -> transformer -> resnet."""

    def __init__(self, ch: int, temb_dim: int, *, context_dim: int,
                 head_dim: int, groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ch, ch, temb_dim, groups) for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(ch, ch // head_dim, head_dim, context_dim,
                               groups=groups)])

    def forward(self, x, temb, context, use_flash: bool = True,
                zero_ctx_prefix: int = 0, fused_conv: bool = False):
        x = self.resnets[0](x, temb, fused=fused_conv)
        x = self.attentions[0](x, context, use_flash=use_flash,
                               zero_ctx_prefix=zero_ctx_prefix)
        return self.resnets[1](x, temb, fused=fused_conv)


def fourier_filter(x, threshold: int = 1, scale: float = 1.0):
    """FreeU's low-frequency rescaling of skip features (NCHW): the centred
    ``2 * threshold``-wide box of the shifted 2-D spectrum is scaled by
    ``scale``. In f32 (torch.fft has no bf16 path), cast back to x's
    dtype."""
    dtype = x.dtype
    h, w = x.shape[-2:]
    dims = (-2, -1)
    x_freq = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=dims),
                                dim=dims)
    mask = torch.ones((h, w), dtype=torch.float32, device=x.device)
    ch, cw = h // 2, w // 2
    mask[ch - threshold:ch + threshold, cw - threshold:cw + threshold] = scale
    x_filtered = torch.fft.ifftn(torch.fft.ifftshift(x_freq * mask,
                                                     dim=dims), dim=dims).real
    return x_filtered.to(dtype)


class UpBlock(nn.Module):
    """CrossAttnUpBlock2D (cross_attn=True) or UpBlock2D. in_ch: channels of
    the skip from the matching down level; prev_ch: channels from below."""

    def __init__(self, in_ch: int, prev_ch: int, out_ch: int, temb_dim: int,
                 num_layers: int, *, cross_attn: bool, context_dim: int,
                 head_dim: int, add_upsample: bool, groups: int = 32):
        super().__init__()
        resnets = []
        for i in range(num_layers):
            res_skip = in_ch if i == num_layers - 1 else out_ch
            res_in = prev_ch if i == 0 else out_ch
            resnets.append(ResnetBlock2D(res_in + res_skip, out_ch, temb_dim,
                                         groups))
        self.resnets = nn.ModuleList(resnets)
        if cross_attn:
            self.attentions = nn.ModuleList([
                Transformer2DModel(out_ch, out_ch // head_dim, head_dim,
                                   context_dim, groups=groups)
                for _ in range(num_layers)])
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_ch)])

    def forward(self, x, skips: List[torch.Tensor], temb, context,
                use_flash: bool = True, zero_ctx_prefix: int = 0,
                fused_conv: bool = False, freeu=None):
        for i, resnet in enumerate(self.resnets):
            # last skip first; the list is left as it was (a rematerialised
            # block runs twice on it, a decode-only step reuses it)
            skip = skips[-1 - i]
            if freeu is not None:
                s, b = freeu
                half = x.shape[1] // 2
                x = torch.cat([x[:, :half] * b, x[:, half:]], dim=1)
                skip = fourier_filter(skip, threshold=1, scale=s)
            x = resnet(torch.cat([x, skip], dim=1), temb, fused=fused_conv)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context, use_flash=use_flash,
                                       zero_ctx_prefix=zero_ctx_prefix)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x
