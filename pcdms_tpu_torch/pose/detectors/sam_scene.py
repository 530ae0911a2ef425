"""Seeded SAM models whose masks survive the generator's filters, and the
files they make in the published layouts.

A SAM with PyTorch's default init predicts mask logits within about +-0.3:
no pixel clears the stability score's +-1.0 offsets, every stability score
is 0 and every box spans the image, so the stability filter, the boxes and
the NMS never decide anything. ``seeded_sam`` draws the default init from
a seed, makes the zero-initialised tables (position embedding,
relative-position and attention-bias tables) and the BatchNorm statistics
random, and crafts the mask head: the hypernetwork's output layer scaled by
``gain`` and one upscaled channel turned into a constant, through which
every mask's logits are lowered by ``shift``. Each mask is then a few
blobs whose logits reach past +1, and the predicted IoU, the stability
score and the NMS each keep some masks and drop others at thresholds
inside their spread.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pcdms_tpu_torch.pose.detectors.sam import Sam, SamConfig

MASK_GAIN = 20.0
MASK_SHIFT = 3.0
# the upscaled channel made constant (GELU(10 + a small value) ~ 10)
_CONSTANT = 10.0


@torch.no_grad()
def seeded_sam(cfg: SamConfig, seed: int, device=None,
               gain: float = MASK_GAIN, shift: float = MASK_SHIFT) -> Sam:
    """``Sam(cfg)`` with PyTorch's default init drawn on ``device`` (None:
    the CPU) after ``torch.manual_seed(seed)``, the zero tables ~ N(0,
    0.05), BatchNorm means ~ U(-0.3, 0.3), variances and scales ~ U(0.5,
    1.5), biases ~ U(-0.1, 0.1) (numpy's draws from ``seed``), and the mask
    head crafted as the module docstring says; in eval mode, not folded."""
    torch.manual_seed(seed)
    with torch.device(device or "cpu"):
        model = Sam(cfg)
    rng = np.random.default_rng(seed)

    def fill(t, values):
        t.copy_(torch.from_numpy(values.astype(np.float32)))

    for name, p in model.named_parameters():
        if name.endswith(("pos_embed", "rel_pos_h", "rel_pos_w",
                          "attention_biases")):
            fill(p, rng.standard_normal(p.shape) * 0.05)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            for attr, lo, hi in (("running_mean", -0.3, 0.3),
                                 ("running_var", 0.5, 1.5),
                                 ("weight", 0.5, 1.5),
                                 ("bias", -0.1, 0.1)):
                v = getattr(m, attr)
                fill(v, rng.uniform(lo, hi, v.shape))
    dec = model.mask_decoder
    dec.output_upscaling[3].bias[0] = _CONSTANT
    for mlp in dec.output_hypernetworks_mlps:
        out = mlp.layers[-1]
        out.weight.mul_(gain)
        out.weight[0] = 0.0
        out.bias[0] = -shift / _CONSTANT
    return model.eval()


def published_state_dict(model: Sam, seed: int) -> Dict[str, torch.Tensor]:
    """``model``'s state dict on the CPU plus the keys a published file
    holds that the port does not read, drawn from ``seed``: the prompt
    encoder's mask downscaling and, for MobileSAM, TinyViT's classifier
    head (``torch.save`` it to write a file in the full published
    layout)."""
    shapes = {"prompt_encoder.mask_downscaling.0.weight": (4, 1, 2, 2),
              "prompt_encoder.mask_downscaling.0.bias": (4,),
              "prompt_encoder.mask_downscaling.1.weight": (4,),
              "prompt_encoder.mask_downscaling.1.bias": (4,),
              "prompt_encoder.mask_downscaling.3.weight": (16, 4, 2, 2),
              "prompt_encoder.mask_downscaling.3.bias": (16,),
              "prompt_encoder.mask_downscaling.4.weight": (16,),
              "prompt_encoder.mask_downscaling.4.bias": (16,),
              "prompt_encoder.mask_downscaling.6.weight": (256, 16, 1, 1),
              "prompt_encoder.mask_downscaling.6.bias": (256,)}
    if model.cfg.tiny:
        shapes.update({"image_encoder.norm_head.weight": (320,),
                       "image_encoder.norm_head.bias": (320,),
                       "image_encoder.head.weight": (1000, 320),
                       "image_encoder.head.bias": (1000,)})
    rng = np.random.default_rng(seed)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    sd.update({k: torch.from_numpy((rng.standard_normal(s) * 0.02).astype(
        np.float32)) for k, s in shapes.items()})
    return sd
