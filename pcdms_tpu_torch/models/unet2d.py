"""Conditional 2D UNet, SD-2.1 family (counterpart of
``pcdms_tpu/models/unet2d.py``), diffusers ``UNet2DConditionModel``
state-dict names.

One module covers the stage-2 inpainting UNet (9 input channels, class
projection of the target CLIP embedding, pose map added after conv_in), its
demo variant (no class embedding) and the stage-3 UNet (8 channels). Public
tensors are NHWC as in the JAX package; the module runs NCHW inside.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from pcdms_tpu_torch.nn.layers import (
    Conv2d, GroupNorm, TimestepEmbedding, silu, timestep_sinusoidal_embedding,
)
from pcdms_tpu_torch.nn.unet_blocks import DownBlock, MidBlock, UpBlock


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 9
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    head_dim: int = 64
    # which down blocks carry cross-attention (SD-2.1: all but the last)
    cross_attn_down: Tuple[bool, ...] = (True, True, True, False)
    class_embed_proj_dim: Optional[int] = None   # 1024 for stage-2
    norm_groups: int = 32
    use_flash: bool = True
    # rematerialise each down / mid / up block in the backward pass
    # (torch.utils.checkpoint, the counterpart of jax.checkpoint)
    remat: bool = False
    # every resnet conv through the fused GroupNorm + SiLU + conv3x3 kernel
    # (inference only: the kernel has no backward)
    fused_conv: bool = False
    # FreeU (s1, s2, b1, b2) on up blocks 0 and 1; None = off
    freeu: Optional[Tuple[float, float, float, float]] = None
    # the LCM student's w-conditioning: width of the guidance-scale
    # embedding added to the time embedding through cond_proj
    time_cond_proj_dim: Optional[int] = None

    @property
    def cross_attn_up(self):
        return tuple(reversed(self.cross_attn_down))

    @property
    def time_embed_dim(self):
        return self.block_out_channels[0] * 4


def stage2_unet_config(with_class_embed: bool = True) -> UNetConfig:
    return UNetConfig(in_channels=9,
                      class_embed_proj_dim=1024 if with_class_embed else None)


def stage3_unet_config() -> UNetConfig:
    return UNetConfig(in_channels=8, class_embed_proj_dim=None)


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        ch0 = cfg.block_out_channels[0]
        temb_dim = cfg.time_embed_dim
        n = len(cfg.block_out_channels)
        groups = cfg.norm_groups
        self.time_embedding = TimestepEmbedding(
            ch0, temb_dim, cond_proj_dim=cfg.time_cond_proj_dim)
        if cfg.class_embed_proj_dim is not None:
            self.class_embedding = TimestepEmbedding(
                cfg.class_embed_proj_dim, temb_dim)
        self.conv_in = Conv2d(cfg.in_channels, ch0, 3, padding=1)

        down, in_ch = [], ch0
        for i, out_ch in enumerate(cfg.block_out_channels):
            down.append(DownBlock(
                in_ch, out_ch, temb_dim, cfg.layers_per_block,
                cross_attn=cfg.cross_attn_down[i],
                context_dim=cfg.cross_attention_dim, head_dim=cfg.head_dim,
                add_downsample=i < n - 1, groups=groups))
            in_ch = out_ch
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = MidBlock(
            cfg.block_out_channels[-1], temb_dim,
            context_dim=cfg.cross_attention_dim, head_dim=cfg.head_dim,
            groups=groups)
        up = []
        rev = tuple(reversed(cfg.block_out_channels))
        prev_ch = rev[0]
        for i in range(n):
            up.append(UpBlock(
                rev[min(i + 1, n - 1)], prev_ch, rev[i], temb_dim,
                cfg.layers_per_block + 1, cross_attn=cfg.cross_attn_up[i],
                context_dim=cfg.cross_attention_dim, head_dim=cfg.head_dim,
                add_upsample=i < n - 1, groups=groups))
            prev_ch = rev[i]
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(groups, ch0, 1e-5)
        self.conv_out = Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def time_embed(self, timesteps, class_labels=None, timestep_cond=None,
                   dtype=torch.float32):
        """Time (+ class-projection) embedding (``unet_time_embedding``)."""
        t_emb = timestep_sinusoidal_embedding(
            timesteps, self.cfg.block_out_channels[0]).to(dtype)
        emb = self.time_embedding(t_emb, condition=timestep_cond)
        if hasattr(self, "class_embedding"):
            if class_labels is None:
                raise ValueError("this UNet requires class_labels")
            if class_labels.dim() == 3:
                class_labels = class_labels[:, 0, :]
            emb = emb + self.class_embedding(class_labels.to(dtype))
        return emb

    def _block(self, block, *args, **kwargs):
        """Run one UNet block, rematerialised under ``cfg.remat``."""
        if self.cfg.remat:
            return checkpoint(block, *args, use_reentrant=False, **kwargs)
        return block(*args, **kwargs)

    def encode(self, sample, emb, ctx, pose_cond=None,
               zero_ctx_prefix: int = 0):
        """conv_in + pose map + down blocks + mid block (``unet_encode``).
        sample, pose_cond: NHWC. Returns (x_mid, skips), NCHW."""
        x = self.conv_in(sample.permute(0, 3, 1, 2))
        if pose_cond is not None:
            x = x + pose_cond.permute(0, 3, 1, 2).to(x.dtype)
        kw = dict(use_flash=self.cfg.use_flash, fused_conv=self.cfg.fused_conv,
                  zero_ctx_prefix=zero_ctx_prefix)
        skips = [x]
        for block in self.down_blocks:
            x, block_skips = self._block(block, x, emb, ctx, **kw)
            skips.extend(block_skips)
        x = self._block(self.mid_block, x, emb, ctx, **kw)
        return x, tuple(skips)

    def decode(self, x, skips, emb, ctx, zero_ctx_prefix: int = 0):
        """Up blocks + output head (``unet_decode``), FreeU on up blocks 0
        and 1 under ``cfg.freeu``. ``skips`` is left as it was. Returns
        NHWC."""
        skips = list(skips)
        for bi, block in enumerate(self.up_blocks):
            nres = len(block.resnets)
            block_skips = skips[-nres:]
            del skips[-nres:]
            freeu = None
            if self.cfg.freeu is not None and bi < 2:
                s1, s2, b1, b2 = self.cfg.freeu
                freeu = (s1, b1) if bi == 0 else (s2, b2)
            x = self._block(block, x, block_skips, emb, ctx,
                            use_flash=self.cfg.use_flash,
                            zero_ctx_prefix=zero_ctx_prefix,
                            fused_conv=self.cfg.fused_conv, freeu=freeu)
        x = self.conv_out(silu(self.conv_norm_out(x)))
        return x.permute(0, 2, 3, 1)

    def forward(self, sample, timesteps, encoder_hidden_states,
                class_labels=None, pose_cond=None, timestep_cond=None,
                zero_ctx_prefix: int = 0):
        """Predict noise. sample: (B, H, W, in_channels) NHWC; timesteps:
        (B,); encoder_hidden_states: (B, L, cross_attention_dim);
        class_labels: (B, D) or (B, 1, D); pose_cond: (B, H, W, ch0);
        zero_ctx_prefix: the first N items have an all-zero context."""
        dtype = sample.dtype
        emb = self.time_embed(timesteps, class_labels, timestep_cond, dtype)
        ctx = encoder_hidden_states.to(dtype)
        x, skips = self.encode(sample, emb, ctx, pose_cond, zero_ctx_prefix)
        return self.decode(x, skips, emb, ctx, zero_ctx_prefix)
