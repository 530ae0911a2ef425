"""LineArt detector (anime2sketch-style ResNet generator) as an
``nn.Module``, NCHW (counterpart of ``pcdms_tpu/pose/detectors/lineart.py``).

controlnet_aux ``lineart/__init__.py``'s ``Generator(3, 1, 3)``: a 7x7
reflect-padded stem, two stride-2 downsamples (64 -> 128 -> 256), 3
residual blocks (reflect pad, conv, InstanceNorm), two transposed-conv
upsamples and a 7x7 sigmoid head giving a 1-channel line map; InstanceNorm
without affine parameters. The layers sit in ``nn.Sequential``s as
published (``model0.1``, ``model1.0``, ``model2.0.conv_block.1``,
``model3.0``, ``model4.1``), so ``sk_model.pth`` (realistic) and
``sk_model2.pth`` (coarse) load as they are. Input RGB in [0, 1]; the
detector inverts the map to white-background line art.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pcdms_tpu_torch.pose import imgproc
from pcdms_tpu_torch.pose.detectors.common import (
    as_image, hwc3, resize_to_64, shape_to_64, to_uint8_map,
)

N_RESIDUAL = 3


class ResidualBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(ch, ch, 3), nn.InstanceNorm2d(ch),
            nn.ReLU(), nn.ReflectionPad2d(1), nn.Conv2d(ch, ch, 3),
            nn.InstanceNorm2d(ch))

    def forward(self, x):
        return x + self.conv_block(x)


class Generator(nn.Module):
    """x: (N, 3, H, W) in [0, 1] -> (N, 1, H, W) line probability."""

    def __init__(self, n_residual: int = N_RESIDUAL):
        super().__init__()
        self.model0 = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(3, 64, 7),
                                    nn.InstanceNorm2d(64), nn.ReLU())
        down = []
        for cin in (64, 128):
            down += [nn.Conv2d(cin, 2 * cin, 3, stride=2, padding=1),
                     nn.InstanceNorm2d(2 * cin), nn.ReLU()]
        self.model1 = nn.Sequential(*down)
        self.model2 = nn.Sequential(*[ResidualBlock(256)
                                      for _ in range(n_residual)])
        up = []
        for cin in (256, 128):
            up += [nn.ConvTranspose2d(cin, cin // 2, 3, stride=2, padding=1,
                                      output_padding=1),
                   nn.InstanceNorm2d(cin // 2), nn.ReLU()]
        self.model3 = nn.Sequential(*up)
        self.model4 = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(64, 1, 7),
                                    nn.Sigmoid())

    def forward(self, x):
        return self.model4(self.model3(self.model2(self.model1(
            self.model0(x)))))


class LineartDetector:
    """The reference's call protocol (lineart/__init__.py:126-166) on the
    port's networks, on ``device`` (None: CUDA), in f32 with TF32 off."""

    def __init__(self, model=None, coarse_model=None, device=None):
        from pcdms_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.model, self.coarse_model = (
            None if m is None else m.to(self.device).eval()
            for m in (model, coarse_model))

    @classmethod
    def from_pretrained(cls, weights_path: str = None,
                        coarse_weights_path: str = None, device=None):
        """From ``sk_model.pth`` / ``sk_model2.pth`` (unpickled: trusted
        local files only)."""
        from pcdms_tpu_torch.pose.detectors.common import load_network
        return cls(*(None if p is None else load_network(Generator(), p)
                     for p in (weights_path, coarse_weights_path)),
                   device=device)

    @torch.no_grad()
    def __call__(self, input_image, coarse: bool = False,
                 detect_resolution: int = 512,
                 image_resolution: int = 512) -> np.ndarray:
        from pcdms_tpu_torch.pose.dwpose import f32_forward
        img = hwc3(as_image(input_image, self.device))
        img = resize_to_64(img, detect_resolution)
        model = self.coarse_model if coarse else self.model
        if model is None:
            raise ValueError(
                f"{'coarse' if coarse else 'realistic'} weights were "
                "not loaded")
        with f32_forward():
            line = model(img.permute(2, 0, 1)[None].float() / 255.0)[0, 0]
        detected = to_uint8_map(line)
        out_hw = shape_to_64(*img.shape[:2], image_resolution)
        detected = imgproc.resize_linear(detected, (out_hw[1], out_hw[0]))
        return 255 - detected.cpu().numpy()
