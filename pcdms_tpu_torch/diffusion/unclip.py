"""UnCLIP ancestral sampler tables (counterpart of
``pcdms_tpu/diffusion/unclip.py``): diffusers ``UnCLIPScheduler`` as the
stage-1 prior pipeline drives it, with explicit ``prev_timestep`` stepping.

  * squaredcos_cap_v2 betas, prediction_type='sample'
  * timesteps: step_ratio = (T-1)/(N-1); round(arange(N)*ratio)[::-1]
  * posterior mean with the effective per-step alpha
    a_t = ac_t / ac_{t_prev}; variance 'fixed_small_log':
    std = sqrt(beta_prod_prev / beta_prod * (1 - a_t)), floored at 1e-20
    before the square root; no noise on the final step (t == 0)
  * x0 prediction clipped to +/- 10

The tables are numpy, computed in float64 and stored in float32, the same
to the bit as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from pcdms_tpu_torch.diffusion.schedules import NoiseSchedule

CLIP_SAMPLE_RANGE = 10.0


def unclip_timesteps(num_train_timesteps: int,
                     num_inference_steps: int) -> np.ndarray:
    if num_inference_steps == 1:
        return np.array([num_train_timesteps - 1], dtype=np.int64)
    ratio = (num_train_timesteps - 1) / (num_inference_steps - 1)
    return (np.arange(num_inference_steps) * ratio).round()[::-1].astype(
        np.int64)


def unclip_step_tables(schedule: NoiseSchedule, num_inference_steps: int):
    """Per-step (timesteps, coef_x0, coef_xt, std):

    x_prev = coef_x0 * clip(x0_pred) + coef_xt * x_t + std * noise
    """
    T = schedule.num_train_timesteps
    ts = unclip_timesteps(T, num_inference_steps)
    ac = np.asarray(schedule.alphas_cumprod, np.float64)
    prev_ts = np.concatenate([ts[1:], np.array([-1], np.int64)])

    ac_t = ac[ts]
    ac_prev = np.where(prev_ts >= 0, ac[np.clip(prev_ts, 0, T - 1)], 1.0)
    beta_prod = 1.0 - ac_t
    beta_prod_prev = 1.0 - ac_prev
    alpha_eff = ac_t / ac_prev
    beta_eff = 1.0 - alpha_eff

    coef_x0 = np.sqrt(ac_prev) * beta_eff / beta_prod
    coef_xt = np.sqrt(alpha_eff) * beta_prod_prev / beta_prod
    variance = beta_prod_prev / beta_prod * beta_eff
    std = np.sqrt(np.clip(variance, 1e-20, None))
    std = np.where(ts > 0, std, 0.0)
    return (np.asarray(ts, np.int32), np.asarray(coef_x0, np.float32),
            np.asarray(coef_xt, np.float32), np.asarray(std, np.float32))


def unclip_clip_x0(x0):
    return torch.clamp(x0, -CLIP_SAMPLE_RANGE, CLIP_SAMPLE_RANGE)
