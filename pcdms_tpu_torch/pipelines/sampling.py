"""Denoising loops (counterpart of ``pcdms_tpu/pipelines/sampling.py``).

Plain Python loops over the precomputed per-step tables; the model is
``model_eps_fn(x, t) -> eps`` with an integer timestep t. The per-step
scalars are float32, as the JAX package's scan inputs are. Also the
options check the stage-2 and stage-3 samplers share, and the per-row noise
streams of ``seeds=``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

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


def check_sampler_options(scheduler: str, eta: float,
                          encoder_cache_interval: int, unet_cfg) -> None:
    """Raise for the sampler options that are not ported yet."""
    if encoder_cache_interval > 1:
        raise NotImplementedError("encoder_cache_interval > 1 (encoder "
                                  "propagation) is not ported yet")
    if scheduler not in SAMPLERS:
        raise NotImplementedError(f"scheduler={scheduler!r} is not ported "
                                  f"yet (have {sorted(SAMPLERS)})")
    if eta > 0.0:
        raise NotImplementedError("eta > 0 (ancestral DDIM) is not ported "
                                  "yet")
    if unet_cfg.time_cond_proj_dim is not None:
        raise NotImplementedError("w-conditioned (LCM) UNets are not "
                                  "ported yet")


def row_generators(seeds: Sequence[int], tag: int,
                   device) -> list:
    """One torch generator per row, seeded from (tag, seed) through numpy's
    ``SeedSequence``: a row's draws depend on its own seed and the stage's
    tag only, never on the batch it runs in. torch streams, not the JAX
    package's threefry ones: the same seed draws other numbers there."""
    out = []
    for seed in np.asarray(seeds).reshape(-1):
        state = np.random.SeedSequence([tag, int(seed)]).generate_state(
            2, np.uint32)
        out.append(torch.Generator(device=device).manual_seed(
            int(state[0]) << 32 | int(state[1])))
    return out


def row_randn(generators: Sequence[torch.Generator], shape,
              device) -> torch.Tensor:
    """(len(generators),) + shape f32 normals, row i from generator i."""
    return torch.stack([torch.randn(tuple(shape), generator=g,
                                    dtype=torch.float32, device=device)
                        for g in generators])
