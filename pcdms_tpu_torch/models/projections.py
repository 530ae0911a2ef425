"""Conditioning projections (counterpart of
``pcdms_tpu/models/projections.py``).

* ``ImageProjModel``: Linear -> GELU -> LayerNorm -> Linear, DINOv2 patch
  features (1536) to the UNet cross-attention width (1024); keys ``net.0``,
  ``net.3``, ``net.4`` as the reference's ``ImageProjModel_p``.
* ``PoseCondEmbedding``: diffusers ``ControlNetConditioningEmbedding``
  (block_out_channels (16, 32, 96, 256) -> 320 channels at 1/8 resolution);
  every second block conv has stride 2. Its conv_out is zero-initialised.
Inputs and outputs are NHWC / (B, L, C) as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch.nn as nn

from pcdms_tpu_torch.nn.layers import Conv2d, LayerNorm, Linear, gelu, silu


class ImageProjModel(nn.Module):
    def __init__(self, in_dim: int = 1536, hidden_dim: int = 768,
                 out_dim: int = 1024):
        super().__init__()
        # indices follow Sequential(Linear, GELU, Dropout, LayerNorm, Linear)
        self.net = nn.ModuleList([
            Linear(in_dim, hidden_dim), nn.Identity(), nn.Identity(),
            LayerNorm(hidden_dim), Linear(hidden_dim, out_dim)])

    def forward(self, x):
        return self.net[4](self.net[3](gelu(self.net[0](x))))


class PoseCondEmbedding(nn.Module):
    def __init__(self, out_channels: int = 320,
                 block_out_channels: Tuple[int, ...] = (16, 32, 96, 256),
                 in_channels: int = 3):
        super().__init__()
        self.conv_in = Conv2d(in_channels, block_out_channels[0], 3,
                                 padding=1)
        blocks = []
        for i in range(len(block_out_channels) - 1):
            cin, cout = block_out_channels[i], block_out_channels[i + 1]
            blocks.append(Conv2d(cin, cin, 3, padding=1))
            blocks.append(Conv2d(cin, cout, 3, padding=1, stride=2))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = Conv2d(block_out_channels[-1], out_channels, 3,
                                  padding=1)
        nn.init.zeros_(self.conv_out.weight)
        nn.init.zeros_(self.conv_out.bias)

    def forward(self, x):
        """x: (B, H, W, 3) skeleton render in [-1, 1] -> (B, H/8, W/8, C)."""
        h = silu(self.conv_in(x.permute(0, 3, 1, 2)))
        for block in self.blocks:
            h = silu(block(h))
        return self.conv_out(h).permute(0, 2, 3, 1)
