"""Denoising loops (counterpart of ``pcdms_tpu/pipelines/sampling.py``).

Plain Python loops over the precomputed per-step tables; the model is
``model_eps_fn(x, t) -> eps`` with an integer timestep t, called once per
step. The per-step scalars are float32, as the JAX package's scan inputs
are. Also the UNet denoiser the stage-2 and stage-3 samplers share (with
encoder propagation), the options check and sampler dispatch they share,
and the per-row noise streams of ``seeds=``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from pcdms_tpu_torch.diffusion.ddim import ddim_step_tables
from pcdms_tpu_torch.diffusion.guidance import apply_cfg
from pcdms_tpu_torch.diffusion.schedules import NoiseSchedule
from pcdms_tpu_torch.diffusion.unipc import unipc_sample
from pcdms_tpu_torch.train.lcm_distill import lcm_boundary_scalings


def _randn_like(x, generator):
    return torch.randn(tuple(x.shape), generator=generator,
                       dtype=torch.float32, device=x.device)


def ddim_sample_loop(schedule: NoiseSchedule, model_eps_fn: Callable,
                     x_init, num_steps: int, eta: float = 0.0,
                     generator: torch.Generator = None):
    """DDIM: deterministic for eta = 0; ancestral for eta > 0, where each
    step adds sigma * z with z one f32 normal of x's shape drawn from
    ``generator`` after the step's model call."""
    if eta > 0.0 and generator is None:
        raise ValueError("eta > 0 requires a generator")
    ts, cx0, ceps, sigma = ddim_step_tables(schedule, num_steps, eta=eta)
    sa = schedule.sqrt_alphas_cumprod[ts]
    ssg = schedule.sqrt_one_minus_alphas_cumprod[ts]
    x = x_init
    for i in range(num_steps):
        eps = model_eps_fn(x, int(ts[i]))
        x0 = (x - float(ssg[i]) * eps) / float(sa[i])
        x = float(cx0[i]) * x0 + float(ceps[i]) * eps
        if eta > 0.0:
            x = x + float(sigma[i]) * _randn_like(x, generator)
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


def lcm_inference_timesteps(num_train_timesteps: int, num_steps: int,
                            origin_steps: int = 50) -> np.ndarray:
    """LCM inference timesteps, picked from the trained skipped-DDIM
    boundary grid descending from the top (diffusers ``LCMScheduler``'s
    selection): sampling off this grid would query the w-conditioning at
    timesteps the distillation never optimised."""
    if not 1 <= origin_steps <= num_train_timesteps \
            or num_train_timesteps % origin_steps:
        raise ValueError(f"origin_steps {origin_steps} must divide "
                         f"{num_train_timesteps}")
    k = num_train_timesteps // origin_steps
    ddim_ts = np.arange(1, origin_steps + 1) * k - 1
    skip = max(len(ddim_ts) // num_steps, 1)
    return ddim_ts[::-1][::skip][:num_steps].astype(np.int32)


def lcm_sample_loop(schedule: NoiseSchedule, model_eps_fn: Callable,
                    x_init, num_steps: int, generator: torch.Generator, *,
                    origin_steps: int = 50):
    """Latent-consistency sampling (arXiv 2310.04378, ``LCMScheduler``): at
    each boundary timestep the student's eps is wrapped in the c_skip /
    c_out parameterization it was distilled under, and the denoised
    estimate is noised again to the next boundary with one f32 normal of
    x's shape from ``generator`` (none after the last step)."""
    ts = lcm_inference_timesteps(schedule.num_train_timesteps, num_steps,
                                 origin_steps)
    a, s = schedule.sqrt_alphas_cumprod, schedule.sqrt_one_minus_alphas_cumprod
    x = x_init
    for i, t in enumerate(int(t) for t in ts):
        eps = model_eps_fn(x, t)
        x0 = (x - float(s[t]) * eps) / float(a[t])
        c_skip, c_out = (float(c) for c in lcm_boundary_scalings(t))
        x = c_skip * x + c_out * x0
        if i < len(ts) - 1:
            t_next = int(ts[i + 1])
            x = float(a[t_next]) * x + float(s[t_next]) * _randn_like(
                x, generator)
    return x


def unet_model_eps(unet, make_inp: Callable, ctx, *,
                   encoder_cache_interval: int = 1,
                   zero_ctx_prefix: int = 0, use_cfg: bool = False,
                   guidance_scale: float = 0.0,
                   guidance_rescale: float = 0.0, class_labels=None,
                   pose_cond=None, timestep_cond=None) -> Callable:
    """The stage-2 / stage-3 denoiser ``model_eps(x, t) -> eps`` (f32, CFG
    applied) over ``unet``. ``make_inp(x, t) -> (unet input, per-sample
    timesteps)`` is the stage's channel concat with its CFG doubling.

    ``encoder_cache_interval`` > 1 is encoder propagation (arXiv
    2312.09608, ``encoder_prop_model_eps`` in the JAX package):
    ``UNet.encode`` (conv_in, down blocks, mid block) runs only on key
    calls, every interval-th and always the first, and its (h, skips) are
    kept; every call runs a fresh ``UNet.time_embed`` and ``UNet.decode``
    on the kept features. The loops call the model once per step, so call
    i is step i, the key steps of the JAX package's scan-carried counter.
    One helper serves both stages so that they cannot diverge. The model
    keeps its count: make one per sampling run."""
    interval = encoder_cache_interval
    zp = zero_ctx_prefix
    calls, cache = 0, None

    def model_eps(x, t):
        nonlocal calls, cache
        inp, tt = make_inp(x, t)
        if interval <= 1:
            eps = unet(inp, tt, ctx, class_labels=class_labels,
                       pose_cond=pose_cond, timestep_cond=timestep_cond,
                       zero_ctx_prefix=zp)
        else:
            emb = unet.time_embed(tt, class_labels, timestep_cond, inp.dtype)
            if calls % interval == 0:
                cache = unet.encode(inp, emb, ctx, pose_cond, zp)
            calls += 1
            eps = unet.decode(*cache, emb, ctx, zp)
        eps = eps.float()
        if use_cfg:
            eps = apply_cfg(eps, guidance_scale, guidance_rescale)
        return eps

    return model_eps


SCHEDULERS = ("ddim", "unipc", "lcm")


def check_sampler_options(scheduler: str, encoder_cache_interval: int,
                          unet_cfg, schedulers=SCHEDULERS) -> None:
    """Raise ValueError where the JAX package refuses: an unknown
    scheduler, and ``scheduler='lcm'`` without a w-conditioned UNet or
    with encoder propagation (few-step sampling has no steps to skip)."""
    if scheduler not in schedulers:
        raise ValueError(f"unknown scheduler {scheduler!r} (have "
                         f"{list(schedulers)})")
    if scheduler == "lcm":
        if unet_cfg.time_cond_proj_dim is None:
            raise ValueError("scheduler='lcm' needs a w-conditioned student "
                             "(UNetConfig.time_cond_proj_dim)")
        if encoder_cache_interval > 1:
            raise ValueError("encoder_cache_interval and scheduler='lcm' "
                             "don't compose (few-step sampling)")


def run_sampler(scheduler: str, schedule: NoiseSchedule,
                model_eps_fn: Callable, x_init, num_steps: int,
                generator: torch.Generator, eta: float = 0.0,
                lcm_origin_steps: int = 50):
    """The loop ``scheduler`` names; ``eta`` is read by DDIM only, as in
    the JAX package."""
    if scheduler == "lcm":
        return lcm_sample_loop(schedule, model_eps_fn, x_init, num_steps,
                               generator, origin_steps=lcm_origin_steps)
    if scheduler == "ddim":
        return ddim_sample_loop(schedule, model_eps_fn, x_init, num_steps,
                                eta=eta, generator=generator)
    return unipc_sample_loop(schedule, model_eps_fn, x_init, num_steps)


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
