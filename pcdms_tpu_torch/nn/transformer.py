"""Transformer blocks (counterpart of ``pcdms_tpu/nn/transformer.py``),
diffusers ``Attention`` / ``FeedForward`` / ``BasicTransformerBlock``
state-dict names.

Pre-norm layout:  x += attn1(norm1(x));  [x += attn2(norm2(x), ctx)];
                  x += ff(norm3(x))
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from pcdms_tpu_torch.nn.layers import LayerNorm, Linear, gelu
from pcdms_tpu_torch.ops.flash_attention import flash_attention_packed


class Attention(nn.Module):
    """Multi-head attention with q/k/v projections. x: (B, Lq, C)."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, qkv_bias: bool = False):
        super().__init__()
        inner = heads * head_dim
        ctx = context_dim if context_dim is not None else query_dim
        self.heads = heads
        self.to_q = Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = Linear(ctx, inner, bias=qkv_bias)
        self.to_v = Linear(ctx, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([Linear(inner, query_dim)])

    def forward(self, x, context=None, use_flash: bool = True):
        ctx = x if context is None else context
        o = flash_attention_packed(self.to_q(x), self.to_k(ctx),
                                   self.to_v(ctx), self.heads,
                                   use_flash=use_flash)
        return self.to_out[0](o)


class _Proj(nn.Module):
    """diffusers ``GEGLU`` / ``GELU`` activation module (a ``proj`` Linear)."""

    def __init__(self, dim: int, inner: int, geglu: bool):
        super().__init__()
        self.geglu = geglu
        self.proj = Linear(dim, inner * 2 if geglu else inner)

    def forward(self, x):
        h = self.proj(x)
        if self.geglu:
            h, gate = h.chunk(2, dim=-1)
            return h * gelu(gate)
        return gelu(h)


class FeedForward(nn.Module):
    """GEGLU (SD UNet) or GELU feed-forward; keys ``net.0.proj``, ``net.2``."""

    def __init__(self, dim: int, mult: int = 4, geglu: bool = True):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([_Proj(dim, inner, geglu), nn.Identity(),
                                  Linear(inner, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """One pre-norm block. context_dim=None -> self-attention only."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, qkv_bias: bool = False,
                 geglu: bool = True):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim, qkv_bias=qkv_bias)
        if context_dim is not None:
            self.norm2 = LayerNorm(dim)
            self.attn2 = Attention(dim, heads, head_dim,
                                   context_dim=context_dim,
                                   qkv_bias=qkv_bias)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim, geglu=geglu)

    def forward(self, x, context=None, use_flash: bool = True,
                zero_ctx_prefix: int = 0):
        """zero_ctx_prefix: the first N batch items carry an all-zero
        context (the CFG unconditional half). With bias-free k/v
        projections their cross-attention is exactly the to_out bias
        (uniform softmax over zero v rows), so it is not computed."""
        x = x + self.attn1(self.norm1(x), use_flash=use_flash)
        if hasattr(self, "attn2"):
            h = self.norm2(x)
            attn2 = self.attn2
            shortcut = (zero_ctx_prefix > 0 and context is not None
                        and attn2.to_k.bias is None
                        and attn2.to_v.bias is None)
            if shortcut:
                u = zero_ctx_prefix
                cond = attn2(h[u:], context[u:], use_flash=use_flash)
                bias = attn2.to_out[0].bias
                if bias is None:
                    uncond = x.new_zeros((u,) + x.shape[1:])
                else:
                    uncond = bias.to(x.dtype).expand((u,) + x.shape[1:])
                x = x + torch.cat([uncond, cond], dim=0)
            else:
                x = x + attn2(h, context, use_flash=use_flash)
        return x + self.ff(self.norm3(x))
