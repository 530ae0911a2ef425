"""Denoising loops (counterpart of ``pcdms_tpu/pipelines/sampling.py``).

Plain Python loops over the precomputed per-step tables; the model is
``model_eps_fn(x, t) -> eps`` with an integer timestep t. The per-step
scalars are float32, as the JAX package's scan inputs are.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from pcdms_tpu_torch.diffusion.ddim import ddim_step_tables
from pcdms_tpu_torch.diffusion.schedules import NoiseSchedule
from pcdms_tpu_torch.diffusion.unipc import unipc_sample


def ddim_sample_loop(schedule: NoiseSchedule, model_eps_fn: Callable,
                     x_init, num_steps: int):
    """Deterministic DDIM (eta = 0)."""
    ts, cx0, ceps = ddim_step_tables(schedule, num_steps)
    sa = schedule.sqrt_alphas_cumprod[ts]
    ssg = schedule.sqrt_one_minus_alphas_cumprod[ts]
    x = x_init
    for i in range(num_steps):
        eps = model_eps_fn(x, int(ts[i]))
        x0 = (x - float(ssg[i]) * eps) / float(sa[i])
        x = float(cx0[i]) * x0 + float(ceps[i]) * eps
    return x


def unipc_sample_loop(schedule: NoiseSchedule, model_eps_fn: Callable,
                      x_init, num_steps: int):
    """UniPC order-2 predictor-corrector over an epsilon-prediction model."""
    ac = schedule.alphas_cumprod

    def model_x0(x, t):
        a = np.sqrt(ac[t])
        s = np.sqrt(np.float32(1.0) - ac[t])
        return (x - float(s) * model_eps_fn(x, t)) / float(a)

    return unipc_sample(schedule, model_x0, x_init, num_steps)


SAMPLERS = {"ddim": ddim_sample_loop, "unipc": unipc_sample_loop}
