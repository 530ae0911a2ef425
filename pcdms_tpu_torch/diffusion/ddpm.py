"""DDPM forward process for training (counterpart of
``pcdms_tpu/diffusion/ddpm.py``): diffusers ``DDPMScheduler.add_noise`` /
``get_velocity``, uniform timesteps and the noise offset. Random draws come
from an explicit ``torch.Generator``."""

from __future__ import annotations

from typing import Optional

import torch

from pcdms_tpu_torch.diffusion.schedules import NoiseSchedule


def _gather(coeffs, t, like):
    c = torch.as_tensor(coeffs, device=t.device)[t].to(like.dtype)
    return c.reshape(c.shape + (1,) * (like.dim() - 1))


def ddpm_add_noise(schedule: NoiseSchedule, x0, noise, t):
    """q(x_t | x_0): sqrt(ac_t) x0 + sqrt(1 - ac_t) noise. t: (B,) ints."""
    a = _gather(schedule.sqrt_alphas_cumprod, t, x0)
    s = _gather(schedule.sqrt_one_minus_alphas_cumprod, t, x0)
    return a * x0 + s * noise


def ddpm_velocity(schedule: NoiseSchedule, x0, noise, t):
    """v-prediction target: sqrt(ac_t) eps - sqrt(1 - ac_t) x0."""
    a = _gather(schedule.sqrt_alphas_cumprod, t, x0)
    s = _gather(schedule.sqrt_one_minus_alphas_cumprod, t, x0)
    return a * noise - s * x0


def sample_timesteps(generator: Optional[torch.Generator], batch_size: int,
                     num_train_timesteps: int, device=None):
    """Uniform integer timesteps in [0, num_train_timesteps), one per
    example."""
    return torch.randint(0, num_train_timesteps, (batch_size,),
                         generator=generator, device=device)


def offset_shape(noise):
    """Shape of the noise offset: per (batch, channel) for NHWC, per batch
    item otherwise."""
    if noise.dim() == 4:
        return (noise.shape[0], 1, 1, noise.shape[-1])
    return noise.shape[:1] + (1,) * (noise.dim() - 1)


def offset_noise(generator: Optional[torch.Generator], noise, offset: float):
    """Noise-offset augmentation: add ``offset`` times a standard-normal
    shift per (batch, channel). noise: (B, H, W, C) or (B, D)."""
    if offset == 0.0:
        return noise
    shift = torch.randn(offset_shape(noise), generator=generator,
                        dtype=noise.dtype, device=noise.device)
    return noise + offset * shift
