"""Latent-consistency distillation of the stage-2 inpainting UNet
(counterpart of ``pcdms_tpu/train/lcm_distill.py``).

It makes the w-conditioned students that the LCM sampler
(``pipelines/sampling.lcm_sample_loop``) consumes, as the JAX package's
trainer does (arXiv 2310.04378, the diffusers trainer's parameterization):

  * a skipped DDIM schedule of N boundary timesteps t_n = (n + 1) k - 1
    over the 1000-step SD-2.1 schedule (k = 1000 / N);
  * one DDIM step of the frozen teacher from t to s = t - k under
    classifier-free guidance at a per-example w ~ U[w_min, w_max];
  * the consistency parameterization f(x, t, w) = c_skip(t) x + c_out(t)
    x0(x, t, w) with c_skip(0) = 1, c_out(0) = 0;
  * the pseudo-Huber loss between the student at (x_t, t, w) and the
    target network at (x_s, s, w).

The target network is the student itself without gradient (momentum 0, as
in the JAX package), so the loss keeps the ``loss_fn(models, batch,
generator)`` contract of ``train/common.py`` and ``run_training`` (ZeRO-1,
resume, the SIGTERM stop, ``--use_ema``) applies unchanged.

As ``train/stage2.py`` does, the loss is split: ``lcm_draws`` makes its
random inputs from a ``torch.Generator`` in the JAX loss's order and
``lcm_distill_loss`` is deterministic given them. Trainable: {"unet" (the
w-conditioned student), "image_proj", "pose_proj"}; frozen: the teacher's
{"unet", "image_proj", "pose_proj"} and the VAE.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pcdms_tpu_torch.diffusion.ddpm import ddpm_add_noise
from pcdms_tpu_torch.diffusion.schedules import NoiseSchedule, sd21_schedule
from pcdms_tpu_torch.nn.layers import guidance_scale_embedding
from pcdms_tpu_torch.parallel.mesh import draw_rows
from pcdms_tpu_torch.utils.tree import cast_tree

Draws = Dict[str, torch.Tensor]


def lcm_boundary_scalings(t, sigma_data: float = 0.5,
                          timestep_scaling: float = 10.0):
    """c_skip / c_out of the consistency boundary condition (diffusers
    ``scalings_for_boundary_conditions``): c_skip(0) = 1, c_out(0) = 0, and
    c_skip ~ 0 away from t = 0. t: raw schedule timesteps (a number or a
    tensor); returns f32 tensors."""
    st = timestep_scaling * torch.as_tensor(t, dtype=torch.float32)
    c_skip = sigma_data ** 2 / (st ** 2 + sigma_data ** 2)
    c_out = st / torch.sqrt(st ** 2 + sigma_data ** 2)
    return c_skip, c_out


def _gather(table, t):
    return torch.as_tensor(table, device=t.device).to(
        torch.float32)[t][:, None, None, None]


def eps_to_x0(schedule: NoiseSchedule, x_t, eps, t):
    """x0 from an epsilon prediction at per-example timesteps t."""
    a = _gather(schedule.sqrt_alphas_cumprod, t)
    s = _gather(schedule.sqrt_one_minus_alphas_cumprod, t)
    return (x_t - s * eps) / a


def ddim_solver_step(schedule: NoiseSchedule, x0, eps, s):
    """The deterministic DDIM move to per-example timesteps s from the
    (x0, eps) decomposition at the current one."""
    a = _gather(schedule.sqrt_alphas_cumprod, s)
    sig = _gather(schedule.sqrt_one_minus_alphas_cumprod, s)
    return a * x0 + sig * eps


def skipped_timesteps(num_train_timesteps: int, num_ddim_timesteps: int):
    """The N boundary timesteps (n + 1) k - 1 of the skipped DDIM schedule
    (int32) and the skip k. ``ValueError`` unless N divides the schedule, as
    in the JAX package: a non-divisor would leave the top of the schedule,
    where few-step sampling starts, untrained."""
    if not 1 <= num_ddim_timesteps <= num_train_timesteps \
            or num_train_timesteps % num_ddim_timesteps:
        raise ValueError(
            f"num_ddim_timesteps={num_ddim_timesteps} must divide "
            f"num_train_timesteps={num_train_timesteps}")
    k = num_train_timesteps // num_ddim_timesteps
    ts = np.arange(1, num_ddim_timesteps + 1) * k - 1
    return ts.astype(np.int32), k


def init_student_from_teacher(teacher_unet: torch.nn.Module, student_cfg):
    """A student UNet (``student_cfg`` sets ``time_cond_proj_dim``) on the
    teacher's device holding copies of the teacher's tensors, plus the
    w-projection ``time_embedding.cond_proj`` the teacher lacks. That
    projection starts at zero, so the student's eps equals the teacher's at
    every w."""
    from pcdms_tpu_torch.models.unet2d import UNet2DConditionModel
    if student_cfg.time_cond_proj_dim is None:
        raise ValueError("student_cfg must set time_cond_proj_dim")
    device = next(teacher_unet.parameters()).device
    with torch.device(device):
        student = UNet2DConditionModel(student_cfg)
    missing, unexpected = student.load_state_dict(
        teacher_unet.state_dict(), strict=False)
    extra = [k for k in missing
             if not k.startswith("time_embedding.cond_proj")]
    if extra or unexpected:
        raise ValueError(f"teacher and student differ beyond cond_proj: "
                         f"missing {extra}, unexpected {unexpected}")
    with torch.no_grad():
        for p in student.time_embedding.cond_proj.parameters():
            p.zero_()
    return student.train(teacher_unet.training)


def lcm_draws(generator: Optional[torch.Generator], batch_size: int,
              latent_hw, num_boundaries: int, w_min: float = 1.5,
              w_max: float = 4.0, device=None) -> Draws:
    """The loss's random inputs in the JAX loss's order: ``vae_gt`` /
    ``vae_masked`` (B, h, w, 4) posterior noises, ``noise`` (B, h, w, 4),
    ``index`` (B,) of the boundary timestep and ``w`` (B,) ~ U[w_min,
    w_max]."""
    shape = (batch_size, *latent_hw, 4)

    def normal():
        return torch.randn(shape, generator=generator, device=device)

    vae_gt, vae_masked, noise = normal(), normal(), normal()
    index = torch.randint(0, num_boundaries, (batch_size,),
                          generator=generator, device=device)
    w = torch.rand((batch_size,), generator=generator, device=device)
    return {"vae_gt": vae_gt, "vae_masked": vae_masked, "noise": noise,
            "index": index, "w": w_min + (w_max - w_min) * w}


def _conditioning(proj, batch, cd):
    """(ctx, class labels, pose map) through one set of projections."""
    clip_embed = batch["clip_embed"].to(cd)
    ctx = torch.cat([proj["image_proj"](batch["dino_features"].to(cd)),
                     clip_embed], dim=1)
    return ctx, clip_embed[:, 0, :], proj["pose_proj"](
        batch["pose_image"].to(cd))


def lcm_distill_loss(models, teacher, vae, batch, draws: Draws, *,
                     schedule: NoiseSchedule, boundary_ts, k: int,
                     huber_c: float = 0.001, sigma_data: float = 0.5,
                     timestep_scaling: float = 10.0,
                     compute_dtype: torch.dtype = torch.bfloat16):
    """Deterministic distillation loss. models: the student's {"unet",
    "image_proj", "pose_proj"}; teacher: the frozen {"unet", "image_proj",
    "pose_proj"}; vae: the frozen VAE in the compute dtype; batch: the
    stage-2 training batch. Returns (f32 loss, {"mean_w"})."""
    # the sampler imports this module: import the pipeline's pieces here
    from pcdms_tpu_torch.pipelines.stage2_inpaint import build_half_mask
    from pcdms_tpu_torch.train.stage2 import _encode
    cd = compute_dtype
    with torch.no_grad():
        latents = _encode(vae, batch["st_image"], draws["vae_gt"], cd)
        masked = _encode(vae, batch["masked_image"], draws["vae_masked"], cd)
    b, lh, lw, _ = latents.shape
    mask = build_half_mask(b, lh, lw, torch.float32, latents.device)
    t = torch.as_tensor(boundary_ts, device=latents.device).long()[
        draws["index"]]
    s = torch.clamp(t - k, min=0)
    x_t = ddpm_add_noise(schedule, latents, draws["noise"], t)
    w = draws["w"]
    w_embed = guidance_scale_embedding(
        w, models["unet"].cfg.time_cond_proj_dim).to(cd)
    inp = torch.cat([x_t, mask, masked], dim=-1).to(cd)
    ctx, class_labels, pose_cond = _conditioning(models, batch, cd)

    # the teacher's CFG-doubled DDIM step t -> s; the unconditional half
    # has zero image features and class labels
    with torch.no_grad():
        t_ctx, t_cl, t_pose = _conditioning(teacher, batch, cd)
        eps2 = teacher["unet"](
            torch.cat([inp, inp]), torch.cat([t, t]),
            torch.cat([torch.zeros_like(t_ctx), t_ctx]),
            class_labels=torch.cat([torch.zeros_like(t_cl), t_cl]),
            pose_cond=torch.cat([t_pose, t_pose]),
            zero_ctx_prefix=b).float()
        eps_u, eps_c = eps2.chunk(2)
        eps_teacher = eps_u + w[:, None, None, None] * (eps_c - eps_u)
        x_s = ddim_solver_step(schedule, eps_to_x0(
            schedule, x_t, eps_teacher, t), eps_teacher, s)

    def consistency_f(x, tt, ctx, class_labels, pose_cond):
        unet_in = torch.cat([x.to(cd), inp[..., 4:]], dim=-1)
        eps = models["unet"](unet_in, tt, ctx, class_labels=class_labels,
                             pose_cond=pose_cond,
                             timestep_cond=w_embed).float()
        c_skip, c_out = lcm_boundary_scalings(tt, sigma_data,
                                              timestep_scaling)
        c_skip = c_skip.to(x.device)[:, None, None, None]
        c_out = c_out.to(x.device)[:, None, None, None]
        return c_skip * x + c_out * eps_to_x0(schedule, x, eps, tt)

    f_student = consistency_f(x_t, t, ctx, class_labels, pose_cond)
    with torch.no_grad():    # the target: the student, no gradient
        f_target = consistency_f(x_s, s, ctx, class_labels, pose_cond)
    diff2 = torch.square(f_student - f_target)
    loss = torch.mean(torch.sqrt(diff2 + huber_c ** 2) - huber_c)
    return loss, {"mean_w": torch.mean(w)}


def lcm_distill_loss_fn(teacher, vae, num_ddim_timesteps: int = 50,
                        w_min: float = 1.5, w_max: float = 4.0,
                        huber_c: float = 0.001, sigma_data: float = 0.5,
                        timestep_scaling: float = 10.0,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        mesh=None):
    """loss_fn(models, batch, generator) -> (loss, {"mean_w"}) for
    ``make_train_step``: ``lcm_draws`` from ``generator`` (this rank's rows
    of the global batch's over ``mesh``), then ``lcm_distill_loss``. The
    teacher and the VAE are cast to the compute dtype once (the caller's
    modules are left as they are)."""
    schedule = sd21_schedule()
    boundary_ts, k = skipped_timesteps(schedule.num_train_timesteps,
                                       num_ddim_timesteps)
    teacher = cast_tree(teacher, compute_dtype)
    vae = cast_tree(vae, compute_dtype)

    def loss_fn(models, batch, generator):
        st = batch["st_image"]
        draws = draw_rows(lambda n: lcm_draws(
            generator, n, (st.shape[1] // 8, st.shape[2] // 8),
            len(boundary_ts), w_min, w_max, st.device), st.shape[0], mesh)
        return lcm_distill_loss(
            models, teacher, vae, batch, draws, schedule=schedule,
            boundary_ts=boundary_ts, k=k, huber_c=huber_c,
            sigma_data=sigma_data, timestep_scaling=timestep_scaling,
            compute_dtype=compute_dtype)

    return loss_fn
