"""DDIM step tables (counterpart of ``pcdms_tpu/diffusion/ddim.py``).

diffusers ``DDIMScheduler`` with the SD-2.1 config: scaled_linear betas,
``steps_offset=1``, 'leading' spacing, ``set_alpha_to_one=False`` (the final
step targets alphas_cumprod[0]). The step is
x <- cx0[i] * x0_pred + ceps[i] * eps_pred.
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
                     steps_offset: int = 1):
    """Returns (timesteps, cx0, ceps), each (N,), for eta = 0 (ancestral
    DDIM is not ported). Step i maps x_{t_i} -> x_{t_{i+1}}."""
    T = schedule.num_train_timesteps
    ts = ddim_timesteps(T, num_inference_steps, steps_offset)
    ratio = T // num_inference_steps
    ac = np.asarray(schedule.alphas_cumprod)

    prev_ts = ts - ratio
    ac_prev = np.where(prev_ts >= 0, ac[np.clip(prev_ts, 0, T - 1)], ac[0])

    cx0 = np.sqrt(ac_prev)
    ceps = np.sqrt(np.maximum(1.0 - ac_prev, 0.0))
    return (np.asarray(ts, np.int32),
            np.asarray(cx0, np.float32),
            np.asarray(ceps, np.float32))
