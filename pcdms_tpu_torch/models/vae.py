"""AutoencoderKL, the SD-2.1 VAE (counterpart of ``pcdms_tpu/models/vae.py``),
diffusers state-dict names.

Encoder: conv_in -> down blocks (resnets; stride-2 conv after all but the
last, on an input padded (0, 1) right/bottom) -> mid (resnet / single-head
attention / resnet) -> GroupNorm / SiLU / conv_out -> quant_conv -> mean
and log-variance (clipped to [-30, 20]). The decoder mirrors it with one
more resnet per block and nearest-2x upsampling. GroupNorm eps is 1e-6.
Images and latents are NHWC at the public functions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pcdms_tpu_torch.nn.layers import (
    Conv2d, GroupNorm, Linear, silu, upsample2x_conv3x3,
)
from pcdms_tpu_torch.nn.unet_blocks import ResnetBlock2D

SD_VAE_SCALING = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = SD_VAE_SCALING


class VAEAttention(nn.Module):
    """Single-head spatial self-attention over the (H*W) tokens, on plain
    torch ops: f32 scores, softmax, weights cast to v's dtype."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, 1e-6)
        self.to_q = Linear(ch, ch)
        self.to_k = Linear(ch, ch)
        self.to_v = Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        tokens = self.group_norm(x).flatten(2).transpose(1, 2)    # (B, HW, C)
        q, k, v = self.to_q(tokens), self.to_k(tokens), self.to_v(tokens)
        s = torch.matmul(q.float(), k.float().transpose(1, 2)) * (c ** -0.5)
        a = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.matmul(a.float(), v.float()).to(v.dtype)
        o = self.to_out[0](o)
        return x + o.transpose(1, 2).reshape(b, c, h, w)


class VAEMidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ch, ch, None, groups, 1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _Conv(nn.Module):
    """A block holding one conv under ``.conv`` (down/upsampler naming)."""

    def __init__(self, ch: int, stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=stride, padding=padding)


class _VAEBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, groups,
                          1e-6)
            for j in range(n)])


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = cfg.block_out_channels, cfg.norm_groups
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        blocks, in_ch = [], chans[0]
        for i, out_ch in enumerate(chans):
            block = _VAEBlock(in_ch, out_ch, cfg.layers_per_block, g)
            if i < len(chans) - 1:
                block.downsamplers = nn.ModuleList(
                    [_Conv(out_ch, stride=2, padding=0)])
            blocks.append(block)
            in_ch = out_ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = VAEMidBlock(chans[-1], g)
        self.conv_norm_out = GroupNorm(g, chans[-1], 1e-6)
        self.conv_out = Conv2d(chans[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "downsamplers"):
                # torch Downsample2D(padding=0): pad (0, 1, 0, 1), stride 2
                h = block.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block(h)
        return self.conv_out(silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = tuple(reversed(cfg.block_out_channels)), cfg.norm_groups
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = VAEMidBlock(rev[0], g)
        blocks, in_ch = [], rev[0]
        for i, out_ch in enumerate(rev):
            block = _VAEBlock(in_ch, out_ch, cfg.layers_per_block + 1, g)
            if i < len(rev) - 1:
                block.upsamplers = nn.ModuleList([_Conv(out_ch)])
            blocks.append(block)
            in_ch = out_ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6)
        self.conv_out = Conv2d(rev[-1], cfg.in_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "upsamplers"):
                h = upsample2x_conv3x3(block.upsamplers[0].conv, h)
        return self.conv_out(silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1)
        self.post_quant_conv = Conv2d(cfg.latent_channels,
                                         cfg.latent_channels, 1)

    def encode_moments(self, x):
        """x: (B, H, W, 3) in [-1, 1] -> (mean, logvar), (B, H/8, W/8, 4)."""
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x, generator: Optional[torch.Generator] = None,
               sample: bool = True):
        """Scaled latents; the posterior mean when no generator is given."""
        mean, logvar = self.encode_moments(x)
        if sample and generator is not None:
            noise = torch.randn(mean.shape, generator=generator,
                                dtype=mean.dtype, device=mean.device)
            mean = mean + torch.exp(0.5 * logvar) * noise
        return mean * self.cfg.scaling_factor

    def decode(self, z):
        """z: scaled latents (B, h, w, 4) -> image (B, 8h, 8w, 3)."""
        z = z.permute(0, 3, 1, 2) / self.cfg.scaling_factor
        h = self.decoder(self.post_quant_conv(z))
        return h.permute(0, 2, 3, 1)
