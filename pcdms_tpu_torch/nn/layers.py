"""Core layers (counterpart of ``pcdms_tpu/nn/layers.py``).

Linear and Conv2d are ``torch.nn``'s own with one change: they cast their
weight and bias to the input's dtype, as ``linear_apply`` / ``conv2d_apply``
do, so f32 master weights train under bf16 compute and their gradients
flow back through the cast (weights (out, in) and OIHW, where the JAX
package keeps (in, out) and HWIO; ``compat/from_jax.py`` transposes).
Convolutions run NCHW inside the modules. The normalisations compute their
statistics in f32 whatever the input dtype and cast back, as the JAX layers
do, and GroupNorm uses the same single-pass variance with its clamp at 0.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _as(t, x):
    return None if t is None else t.to(x.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` computing in the input's dtype (``linear_apply``)."""

    def forward(self, x):
        return F.linear(x, _as(self.weight, x), _as(self.bias, x))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in the input's dtype (``conv2d_apply``)."""

    def forward(self, x):
        return self._conv_forward(x, _as(self.weight, x), _as(self.bias, x))


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, computed in f32 (``layer_norm_apply``)."""

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm over NCHW (or (B, C, L)) inputs, stats in f32.

    Mirrors ``_group_affine`` (``pcdms_tpu/nn/layers.py:118-165``): per-group
    sum and sum of squares, var = max(E[x^2] - mean^2, 0) (the clamp keeps
    near-constant groups from a negative variance), folded into a per-(B, C)
    affine."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        b, c = x.shape[:2]
        g = self.num_groups
        x32 = x.float()
        flat = x32.reshape(b, c, -1)
        s1 = flat.sum(-1).reshape(b, g, c // g).sum(-1)          # (B, G)
        s2 = (flat * flat).sum(-1).reshape(b, g, c // g).sum(-1)
        n = flat.shape[-1] * (c // g)
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + self.eps)
        a = rstd.repeat_interleave(c // g, dim=1) * self.weight.float()
        off = self.bias.float() - mean.repeat_interleave(c // g, dim=1) * a
        shape = (b, c) + (1,) * (x.dim() - 2)
        return (x32 * a.reshape(shape) + off.reshape(shape)).to(x.dtype)


def gelu(x):
    """Exact (erf) GELU."""
    return F.gelu(x)


def silu(x):
    return F.silu(x)


def timestep_sinusoidal_embedding(timesteps, dim: int,
                                  flip_sin_to_cos: bool = True,
                                  downscale_freq_shift: float = 0.0,
                                  max_period: float = 10000.0,
                                  scale: float = 1.0):
    """diffusers ``Timesteps`` features. timesteps: (B,) -> (B, dim) f32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = scale * emb
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


def guidance_scale_embedding(w, embedding_dim: int):
    """LCM guidance-scale embedding: sinusoidal features of
    (w - 1) * 1000. w: (B,) floats -> (B, embedding_dim) f32."""
    return timestep_sinusoidal_embedding(
        (w - 1.0) * 1000.0, embedding_dim, flip_sin_to_cos=False,
        downscale_freq_shift=1.0)


class TimestepEmbedding(nn.Module):
    """diffusers ``TimestepEmbedding``: linear_1 -> SiLU -> linear_2, with an
    optional bias-free ``cond_proj`` added to the input features."""

    def __init__(self, in_dim: int, time_embed_dim: int,
                 out_dim: Optional[int] = None,
                 cond_proj_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = Linear(in_dim, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, out_dim or time_embed_dim)
        if cond_proj_dim is not None:
            self.cond_proj = Linear(cond_proj_dim, in_dim, bias=False)

    def forward(self, x, condition=None):
        if condition is not None and hasattr(self, "cond_proj"):
            x = x + self.cond_proj(condition)
        return self.linear_2(silu(self.linear_1(x)))


def upsample2x_conv3x3(conv: Conv2d, x):
    """Nearest-2x upsample then a 3x3 'same' conv, NCHW. The JAX package
    evaluates the same function by output phases (``upsample2x_conv3x3``,
    ``pcdms_tpu/nn/layers.py:276``)."""
    return conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
