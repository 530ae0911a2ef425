"""Classifier-free guidance (counterpart of
``pcdms_tpu/diffusion/guidance.py``): the model runs on a doubled batch
``[uncond; cond]`` and the halves are mixed, with optional guidance-rescale
("Common Diffusion Noise Schedules and Sample Steps are Flawed")."""

from __future__ import annotations

import torch


def apply_cfg(model_out_doubled, guidance_scale: float,
              guidance_rescale: float = 0.0):
    """model_out_doubled: (2B, ...) with [uncond; cond] halves."""
    uncond, cond = model_out_doubled.chunk(2, dim=0)
    out = uncond + guidance_scale * (cond - uncond)
    if guidance_rescale > 0.0:
        out = rescale_noise_cfg(out, cond, guidance_rescale)
    return out


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale: float):
    dims = tuple(range(1, noise_cfg.dim()))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, unbiased=False)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, unbiased=False)
    rescaled = noise_cfg * (std_text / torch.clamp(std_cfg, min=1e-12))
    return (guidance_rescale * rescaled
            + (1.0 - guidance_rescale) * noise_cfg)
