"""DDIM step tables (counterpart of ``pcdms_tpu/diffusion/ddim.py``).

diffusers ``DDIMScheduler`` with the SD-2.1 config: scaled_linear betas,
``steps_offset=1``, 'leading' spacing, ``set_alpha_to_one=False`` (the final
step targets alphas_cumprod[0]). The step is
x <- cx0[i] * x0_pred + ceps[i] * eps_pred (+ sigma[i] * z for eta > 0).
"""

from __future__ import annotations

import numpy as np

from pcdms_tpu_torch.diffusion.schedules import NoiseSchedule


def ddim_timesteps(num_train_timesteps: int, num_inference_steps: int,
                   steps_offset: int = 1) -> np.ndarray:
    """'leading' spacing: arange(N) * (T // N), descending, + offset."""
    ratio = num_train_timesteps // num_inference_steps
    t = (np.arange(num_inference_steps) * ratio).round()[::-1].astype(np.int64)
    return t + steps_offset


def ddim_step_tables(schedule: NoiseSchedule, num_inference_steps: int,
                     steps_offset: int = 1, eta: float = 0.0):
    """Returns (timesteps, cx0, ceps, sigma), each (N,). Step i maps
    x_{t_i} -> x_{t_{i+1}}. eta > 0 adds diffusers' ancestral noise term:
    sigma_i = eta * sqrt((1 - ac_prev) / (1 - ac_t) * (1 - ac_t / ac_prev)),
    and the epsilon coefficient becomes sqrt(1 - ac_prev - sigma^2)."""
    T = schedule.num_train_timesteps
    ts = ddim_timesteps(T, num_inference_steps, steps_offset)
    ratio = T // num_inference_steps
    ac = np.asarray(schedule.alphas_cumprod)

    prev_ts = ts - ratio
    ac_t = ac[np.clip(ts, 0, T - 1)]
    ac_prev = np.where(prev_ts >= 0, ac[np.clip(prev_ts, 0, T - 1)], ac[0])

    sigma = eta * np.sqrt((1.0 - ac_prev) / (1.0 - ac_t)
                          * (1.0 - ac_t / ac_prev))
    cx0 = np.sqrt(ac_prev)
    ceps = np.sqrt(np.maximum(1.0 - ac_prev - sigma ** 2, 0.0))
    return (np.asarray(ts, np.int32),
            np.asarray(cx0, np.float32),
            np.asarray(ceps, np.float32),
            np.asarray(sigma, np.float32))
