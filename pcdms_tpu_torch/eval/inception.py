"""InceptionV3 up to pool3 (2048-d) for FID (counterpart of
``pcdms_tpu/eval/inception.py``), NCHW on any device.

The FID network of the reference (pytorch-fid's ``FIDInceptionA/C/E``):
avg-pool with ``count_include_pad=False`` in the A, C and first E blocks,
a MAX branch-pool in ``Mixed_7c``. Every conv is followed by BatchNorm
(eps 1e-3) and ReLU; the BatchNorm is folded into the conv's weight and
bias when the weights are loaded (``fold_state_dict``), so the module
holds one biased conv per unit. The weights are the pt_inception /
torchvision key layout (``Mixed_5b.branch1x1.conv.weight``, ``.bn.*``),
read from a local file through ``compat/load.py``; nothing is downloaded.

Input protocol: images in [0, 1], bilinearly resized to 299x299, scaled to
[-1, 1]. The resize antialiases, as ``jax.image.resize`` does in the JAX
package: at the 512 protocol (352x512 -> 299x299, a downsample) a plain
bilinear resize differs from it by about 0.5; upstream pytorch-fid does
not antialias. The forward runs in f32 with TF32 off, so the features do
not depend on the caller's cuDNN setting.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from pcdms_tpu_torch.eval import f32_convs

BN_EPS = 1e-3
# unit prefix -> (cin, cout, (kh, kw), stride, (ph, pw)), in forward order
UNITS: Dict[str, tuple] = {}


def _unit(prefix, cin, cout, k, s=1, p=0):
    k = (k, k) if isinstance(k, int) else k
    p = (p, p) if isinstance(p, int) else p
    UNITS[prefix] = (cin, cout, k, s, p)


_unit("Conv2d_1a_3x3", 3, 32, 3, 2)
_unit("Conv2d_2a_3x3", 32, 32, 3)
_unit("Conv2d_2b_3x3", 32, 64, 3, 1, 1)
_unit("Conv2d_3b_1x1", 64, 80, 1)
_unit("Conv2d_4a_3x3", 80, 192, 3)
for _name, _cin, _pool in (("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64),
                           ("Mixed_5d", 288, 64)):
    _unit(f"{_name}.branch1x1", _cin, 64, 1)
    _unit(f"{_name}.branch5x5_1", _cin, 48, 1)
    _unit(f"{_name}.branch5x5_2", 48, 64, 5, 1, 2)
    _unit(f"{_name}.branch3x3dbl_1", _cin, 64, 1)
    _unit(f"{_name}.branch3x3dbl_2", 64, 96, 3, 1, 1)
    _unit(f"{_name}.branch3x3dbl_3", 96, 96, 3, 1, 1)
    _unit(f"{_name}.branch_pool", _cin, _pool, 1)
_unit("Mixed_6a.branch3x3", 288, 384, 3, 2)
_unit("Mixed_6a.branch3x3dbl_1", 288, 64, 1)
_unit("Mixed_6a.branch3x3dbl_2", 64, 96, 3, 1, 1)
_unit("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 2)
for _name, _c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                   ("Mixed_6e", 192)):
    _unit(f"{_name}.branch1x1", 768, 192, 1)
    _unit(f"{_name}.branch7x7_1", 768, _c7, 1)
    _unit(f"{_name}.branch7x7_2", _c7, _c7, (1, 7), 1, (0, 3))
    _unit(f"{_name}.branch7x7_3", _c7, 192, (7, 1), 1, (3, 0))
    _unit(f"{_name}.branch7x7dbl_1", 768, _c7, 1)
    _unit(f"{_name}.branch7x7dbl_2", _c7, _c7, (7, 1), 1, (3, 0))
    _unit(f"{_name}.branch7x7dbl_3", _c7, _c7, (1, 7), 1, (0, 3))
    _unit(f"{_name}.branch7x7dbl_4", _c7, _c7, (7, 1), 1, (3, 0))
    _unit(f"{_name}.branch7x7dbl_5", _c7, 192, (1, 7), 1, (0, 3))
    _unit(f"{_name}.branch_pool", 768, 192, 1)
_unit("Mixed_7a.branch3x3_1", 768, 192, 1)
_unit("Mixed_7a.branch3x3_2", 192, 320, 3, 2)
_unit("Mixed_7a.branch7x7x3_1", 768, 192, 1)
_unit("Mixed_7a.branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3))
_unit("Mixed_7a.branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0))
_unit("Mixed_7a.branch7x7x3_4", 192, 192, 3, 2)
for _name, _cin in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
    _unit(f"{_name}.branch1x1", _cin, 320, 1)
    _unit(f"{_name}.branch3x3_1", _cin, 384, 1)
    _unit(f"{_name}.branch3x3_2a", 384, 384, (1, 3), 1, (0, 1))
    _unit(f"{_name}.branch3x3_2b", 384, 384, (3, 1), 1, (1, 0))
    _unit(f"{_name}.branch3x3dbl_1", _cin, 448, 1)
    _unit(f"{_name}.branch3x3dbl_2", 448, 384, 3, 1, 1)
    _unit(f"{_name}.branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1))
    _unit(f"{_name}.branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0))
    _unit(f"{_name}.branch_pool", _cin, 192, 1)


def _avg_pool_nip(x):
    """3x3 stride-1 avg pool, padding 1, count_include_pad=False."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionV3(nn.Module):
    """FID InceptionV3 to pool3 with BatchNorm folded: one biased conv per
    unit of ``UNITS``, named after it (``Mixed_5b.branch1x1.weight``)."""

    def __init__(self):
        super().__init__()
        for prefix, (cin, cout, k, s, p) in UNITS.items():
            block, _, branch = prefix.partition(".")
            conv = nn.Conv2d(cin, cout, k, stride=s, padding=p)
            if not branch:
                setattr(self, block, conv)
                continue
            if not hasattr(self, block):
                setattr(self, block, nn.Module())
            setattr(getattr(self, block), branch, conv)

    def _c(self, prefix, x):
        block, _, branch = prefix.partition(".")
        conv = getattr(self, block)
        return F.relu(getattr(conv, branch)(x) if branch else conv(x))

    def _block_a(self, n, x):
        b1 = self._c(f"{n}.branch1x1", x)
        b5 = self._c(f"{n}.branch5x5_2", self._c(f"{n}.branch5x5_1", x))
        bd = self._c(f"{n}.branch3x3dbl_1", x)
        bd = self._c(f"{n}.branch3x3dbl_2", bd)
        bd = self._c(f"{n}.branch3x3dbl_3", bd)
        bp = self._c(f"{n}.branch_pool", _avg_pool_nip(x))
        return torch.cat([b1, b5, bd, bp], 1)

    def _block_b(self, n, x):
        b3 = self._c(f"{n}.branch3x3", x)
        bd = self._c(f"{n}.branch3x3dbl_1", x)
        bd = self._c(f"{n}.branch3x3dbl_2", bd)
        bd = self._c(f"{n}.branch3x3dbl_3", bd)
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)

    def _block_c(self, n, x):
        b1 = self._c(f"{n}.branch1x1", x)
        b7 = x
        for i in (1, 2, 3):
            b7 = self._c(f"{n}.branch7x7_{i}", b7)
        bd = x
        for i in (1, 2, 3, 4, 5):
            bd = self._c(f"{n}.branch7x7dbl_{i}", bd)
        bp = self._c(f"{n}.branch_pool", _avg_pool_nip(x))
        return torch.cat([b1, b7, bd, bp], 1)

    def _block_d(self, n, x):
        b3 = self._c(f"{n}.branch3x3_2", self._c(f"{n}.branch3x3_1", x))
        b7 = x
        for i in (1, 2, 3, 4):
            b7 = self._c(f"{n}.branch7x7x3_{i}", b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)

    def _block_e(self, n, x, max_branch_pool: bool):
        b1 = self._c(f"{n}.branch1x1", x)
        b3 = self._c(f"{n}.branch3x3_1", x)
        b3 = torch.cat([self._c(f"{n}.branch3x3_2a", b3),
                        self._c(f"{n}.branch3x3_2b", b3)], 1)
        bd = self._c(f"{n}.branch3x3dbl_1", x)
        bd = self._c(f"{n}.branch3x3dbl_2", bd)
        bd = torch.cat([self._c(f"{n}.branch3x3dbl_3a", bd),
                        self._c(f"{n}.branch3x3dbl_3b", bd)], 1)
        bp = (F.max_pool2d(x, 3, 1, 1) if max_branch_pool
              else _avg_pool_nip(x))
        bp = self._c(f"{n}.branch_pool", bp)
        return torch.cat([b1, b3, bd, bp], 1)

    def forward(self, images):
        """images: (B, H, W, 3) in [0, 1] -> (B, 2048) pool3 features."""
        x = images.permute(0, 3, 1, 2).float()
        with f32_convs():
            x = F.interpolate(x, size=(299, 299), mode="bilinear",
                              align_corners=False, antialias=True)
            x = 2.0 * x - 1.0
            for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
                x = self._c(name, x)
            x = F.max_pool2d(x, 3, 2)
            x = self._c("Conv2d_3b_1x1", x)
            x = self._c("Conv2d_4a_3x3", x)
            x = F.max_pool2d(x, 3, 2)
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
                x = self._block_a(name, x)
            x = self._block_b("Mixed_6a", x)
            for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
                x = self._block_c(name, x)
            x = self._block_d("Mixed_7a", x)
            x = self._block_e("Mixed_7b", x, max_branch_pool=False)
            x = self._block_e("Mixed_7c", x, max_branch_pool=True)
            return x.mean(dim=(2, 3))


def fold_state_dict(sd: Dict[str, torch.Tensor], eps: float = BN_EPS
                    ) -> Dict[str, torch.Tensor]:
    """pt_inception / torchvision state dict (``<unit>.conv.weight`` and
    ``<unit>.bn.{weight,bias,running_mean,running_var}``) -> the folded
    module's (``<unit>.weight``, ``<unit>.bias``), in f32. Keys outside
    ``UNITS`` (torchvision's ``fc``, ``AuxLogits``) are not read."""
    out = {}
    for prefix in UNITS:
        w = sd[f"{prefix}.conv.weight"].float()
        gamma = sd[f"{prefix}.bn.weight"].float()
        mean = sd[f"{prefix}.bn.running_mean"].float()
        scale = gamma / torch.sqrt(sd[f"{prefix}.bn.running_var"].float()
                                   + eps)
        out[f"{prefix}.weight"] = w * scale[:, None, None, None]
        out[f"{prefix}.bias"] = sd[f"{prefix}.bn.bias"].float() - mean * scale
    return out


def load_inception(weights_path: str, device=None) -> InceptionV3:
    """The FID network from a local torch weight file, on ``device`` (None:
    CUDA), in eval mode."""
    from pcdms_tpu_torch.compat.load import load_state_dict
    from pcdms_tpu_torch.utils.device import resolve_device
    model = InceptionV3()
    model.load_state_dict(fold_state_dict(load_state_dict(weights_path)))
    return model.to(resolve_device(device)).eval()


def make_inception_feature_fn(weights_path: str, device=None):
    """Local torch weights -> feature_fn: (B, H, W, 3) in [0, 1] (array or
    tensor) -> (B, 2048) f32 pool3 features on ``device`` (None: CUDA)."""
    model = load_inception(weights_path, device)
    dev = next(model.parameters()).device

    @torch.no_grad()
    def feature_fn(images):
        return model(torch.as_tensor(images, dtype=torch.float32,
                                     device=dev))

    return feature_fn
