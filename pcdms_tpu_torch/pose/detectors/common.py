"""What the DWPose networks share: the mm checkpoint reader and ``ConvModule``
with its BatchNorm folding (counterparts of the parts of
``pcdms_tpu/pose/detectors/common.py`` and ``yolox.py`` that DWPose uses)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# the dicts a released checkpoint may wrap its state dict in, taken off in
# this order (LeReS's ``res101.pth`` keeps its under ``depth_model``)
WRAPPERS = ("state_dict", "model", "depth_model", "module")


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """An mm or controlnet-aux checkpoint -> {name: np.ndarray}: the
    ``WRAPPERS`` are taken off in that order wherever they hold a dict, then
    ``"module."`` is removed from every key. The file is unpickled: read
    only trusted local files."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in WRAPPERS:
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

    def fold_bn(self) -> None:
        if not isinstance(self.bn, nn.Identity):
            fold_conv_bn(self.conv, self.bn)
            self.bn = nn.Identity()


@torch.no_grad()
def fold_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> None:
    """Fold ``bn`` into ``conv`` in place, as the JAX converters do, in
    numpy's f32 (``scale = gamma / sqrt(var + eps)``; the kernel times
    ``scale``; the bias ``(beta - mean * scale) + conv_bias * scale``):
    PyTorch's vectorised CPU sqrt is not always correctly rounded."""
    def f32(t):
        return t.detach().cpu().numpy().astype(np.float32)
    scale = f32(bn.weight) / np.sqrt(f32(bn.running_var) + bn.eps)
    bias = f32(bn.bias) - f32(bn.running_mean) * scale
    if conv.bias is not None:
        bias = bias + f32(conv.bias) * scale
    dev = conv.weight.device
    conv.weight.copy_(torch.from_numpy(
        f32(conv.weight) * scale[:, None, None, None]).to(dev))
    conv.bias = nn.Parameter(torch.from_numpy(bias).to(dev))


def fold_bn_pairs(model: nn.Module, pairs) -> nn.Module:
    """Fold each (conv name, BatchNorm name) of ``pairs`` in ``model`` and
    put an identity in the BatchNorm's place; a pair already folded is
    left as it is. -> ``model``."""
    for conv_name, bn_name in pairs:
        bn = model.get_submodule(bn_name)
        if isinstance(bn, nn.BatchNorm2d):
            fold_conv_bn(model.get_submodule(conv_name), bn)
            parent, _, leaf = bn_name.rpartition(".")
            setattr(model.get_submodule(parent), leaf, nn.Identity())
    return model


def sequential_bn_pairs(model: nn.Module):
    """The (conv, BatchNorm) name pairs of ``model`` that sit next to each
    other in an ``nn.Sequential``."""
    pairs = []
    for name, m in model.named_modules():
        if isinstance(m, nn.Sequential):
            items = list(m.named_children())
            for (a, ma), (b, mb) in zip(items, items[1:]):
                if (isinstance(ma, nn.Conv2d)
                        and isinstance(mb, nn.BatchNorm2d)):
                    pre = f"{name}." if name else ""
                    pairs.append((pre + a, pre + b))
    return pairs


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


# ---------------------------------------------------------------------------
# the annotators' image protocol (controlnet-aux ``util.py``), on uint8
# (H, W, C) tensors on any device through ``pose/imgproc.py``
# ---------------------------------------------------------------------------

def as_image(image, device=None) -> torch.Tensor:
    """A PIL image, array or tensor -> an (H, W[, C]) uint8 tensor on
    ``device`` (None: where a tensor is; an array goes to the CPU). A PIL
    image keeps its own channels, as ``np.asarray`` gives them."""
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.array(image, np.uint8))
    return image if device is None else image.to(device)


def hwc3(x: torch.Tensor) -> torch.Tensor:
    """Coerce to 3-channel uint8 (util.py:HWC3, alpha composited onto
    white, in f32, truncated)."""
    assert x.dtype == torch.uint8
    if x.dim() == 2:
        x = x[:, :, None]
    c = x.shape[2]
    if c == 3:
        return x
    if c == 1:
        return torch.cat([x] * 3, dim=2)
    color = x[:, :, :3].float()
    alpha = x[:, :, 3:4].float() / 255.0
    return (color * alpha + 255.0 * (1.0 - alpha)).clamp(0, 255).to(
        torch.uint8)


def shape_to_64(h: int, w: int, resolution: int):
    """The output grid ``resize_to_64`` would produce, without resizing."""
    k = float(resolution) / min(h, w)
    return (int(np.round(h * k / 64.0)) * 64,
            int(np.round(w * k / 64.0)) * 64)


def resize_to_64(img: torch.Tensor, resolution: int) -> torch.Tensor:
    """Scale so min side ~= resolution, snapped to multiples of 64
    (util.py:resize_image: Lanczos-4 to enlarge, area to shrink)."""
    from pcdms_tpu_torch.pose import imgproc
    h, w = img.shape[:2]
    nh, nw = shape_to_64(h, w, resolution)
    interp = "lanczos4" if resolution > min(h, w) else "area"
    return imgproc.resize(img, (nw, nh), interp)


_NMS_KERNELS = [np.array([[0, 0, 0], [1, 1, 1], [0, 0, 0]], np.uint8),
                np.array([[0, 1, 0], [0, 1, 0], [0, 1, 0]], np.uint8),
                np.eye(3, dtype=np.uint8),
                np.eye(3, dtype=np.uint8)[::-1].copy()]


def edge_nms(x: torch.Tensor, t: float, s: float) -> torch.Tensor:
    """Directional edge thinning (util.py:nms): keep the pixels that are
    the maximum of the Gaussian-blurred map along one of 4 line
    directions, then threshold to {0, 255}."""
    from pcdms_tpu_torch.pose import imgproc
    x = imgproc.gaussian_blur(x.float(), s)
    y = torch.zeros_like(x)
    for f in _NMS_KERNELS:
        y = torch.where(imgproc.dilate(x, f) == x, x, y)
    return torch.where(y > t, 255, 0).to(torch.uint8)


def scribble_postprocess(detected: torch.Tensor) -> torch.Tensor:
    """NMS + blur + binarize of the hed / pidi scribble modes
    (hed/__init__.py:124-127)."""
    from pcdms_tpu_torch.pose import imgproc
    out = imgproc.gaussian_blur(edge_nms(detected, 127, 3.0), 3.0)
    return torch.where(out > 4, 255, 0).to(torch.uint8)


def safe_step(x: torch.Tensor, step: int = 2) -> torch.Tensor:
    """Quantize [0, 1] maps to step + 1 levels (util.py:safe_step)."""
    y = x.float() * float(step + 1)
    return y.to(torch.int32).float() / float(step)


def to_uint8_map(edge: torch.Tensor) -> torch.Tensor:
    """A [0, 1] (H, W) map -> its (H, W, 3) uint8 image
    (``hwc3((edge * 255).clip(0, 255).astype(uint8))``, in the map's own
    f32 or f64)."""
    return hwc3((edge * 255.0).clamp(0, 255).to(torch.uint8))


def transfer_state_dict(model: nn.Module, sd: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
    """controlnet-aux ``util.transfer``: where a checkpoint stores a key
    without the model's first name component (the released OpenPose files
    name ``conv1_1.weight`` what the model calls ``model0.conv1_1.weight``),
    take it under the model's name; keys already the model's pass as they
    are."""
    out = dict(sd)
    for name in model.state_dict():
        if name not in out:
            short = name.split(".", 1)[-1]
            if short in sd:
                out[name] = sd[short]
                out.pop(short, None)
    return out


def empty(cls, *args, **kwargs) -> nn.Module:
    """``cls(*args, **kwargs)`` built on the meta device and given
    uninitialised CPU memory, for a module whose every parameter and buffer
    a checkpoint then loads (``load_network`` raises on a missing key): a
    344M-parameter ZoeDepth skips seconds of random initialisation."""
    with torch.device("meta"):
        module = cls(*args, **kwargs)
    return module.to_empty(device="cpu")


def load_network(model: nn.Module, path: str) -> nn.Module:
    """Load a controlnet-aux annotator checkpoint into ``model``
    (``compat/load.py::load_into``: a key the model lacks is dropped with a
    log line, a missing one raises), its wrappers taken off by
    ``load_torch_state_dict``, names mapped by ``transfer_state_dict``. ->
    ``model`` in eval mode."""
    from pcdms_tpu_torch.compat.load import load_into
    sd = transfer_state_dict(model, load_torch_state_dict(path))
    return load_into(model, {k: torch.from_numpy(v) for k, v in sd.items()},
                     path).eval()
