"""What the DWPose networks share: the mm checkpoint reader and ``ConvModule``
with its BatchNorm folding (counterparts of the parts of
``pcdms_tpu/pose/detectors/common.py`` and ``yolox.py`` that DWPose uses)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """An mm checkpoint -> {name: np.ndarray}: the ``state_dict``, ``model``
    and ``module`` wrappers are taken off in that order wherever they hold a
    dict, then ``"module."`` is removed from every key. The file is
    unpickled: read only trusted local files."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "module"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    return {k.replace("module.", ""): v.detach().numpy()
            for k, v in sd.items()}


class ConvModule(nn.Module):
    """mm's ConvModule: a conv without bias, BatchNorm, SiLU. ``fold_bn``
    turns it into one biased conv and SiLU (``bn`` becomes an identity)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 eps: float = 1e-3, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, (k - 1) // 2,
                              bias=False, groups=groups)
        self.bn = nn.BatchNorm2d(cout, eps=eps)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))

    @torch.no_grad()
    def fold_bn(self) -> None:
        if isinstance(self.bn, nn.Identity):
            return
        bn, conv = self.bn, self.conv
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        folded = nn.Conv2d(conv.in_channels, conv.out_channels,
                           conv.kernel_size, conv.stride, conv.padding,
                           groups=conv.groups, bias=True).to(conv.weight)
        folded.weight.copy_(conv.weight * scale[:, None, None, None])
        folded.bias.copy_(bn.bias - bn.running_mean * scale)
        self.conv, self.bn = folded, nn.Identity()


def fold_bn(model: nn.Module) -> nn.Module:
    """Fold every ``ConvModule``'s BatchNorm into its conv, in place (as
    the JAX package's ``fold_bn`` does when it converts a checkpoint);
    -> ``model``."""
    for m in model.modules():
        if isinstance(m, ConvModule):
            m.fold_bn()
    return model


class SPPBottleneck(nn.Module):
    """1x1 conv to half the channels, max pools of 5, 9 and 13 (stride 1,
    padded with -inf), concatenated with their input, 1x1 conv."""

    def __init__(self, cin: int, cout: int, eps: float):
        super().__init__()
        self.conv1 = ConvModule(cin, cin // 2, 1, eps=eps)
        self.conv2 = ConvModule(cin // 2 * 4, cout, 1, eps=eps)

    def forward(self, x):
        h = self.conv1(x)
        return self.conv2(torch.cat(
            [h] + [F.max_pool2d(h, k, 1, k // 2) for k in (5, 9, 13)], 1))
