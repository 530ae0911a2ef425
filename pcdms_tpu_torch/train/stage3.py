"""Stage-3 refinement UNet training loss (counterpart of
``pcdms_tpu/train/stage3.py``).

  * VAE-encode the ground-truth target and the stage-2 image with the
    frozen VAE (no grad, compute dtype, posterior sample);
  * the 8-channel input [noisy target latents, stage-2 latents];
  * cross-attention over ``image_proj(DINOv2 features)`` only: no class
    labels, no pose map;
  * epsilon (or v) MSE with the noise offset.

Split as ``train/stage2.py`` is: ``stage3_draws`` makes the five random
inputs from a ``torch.Generator`` (the two VAE posterior noises, the noise,
the offset shift, the timesteps) and ``stage3_loss`` is deterministic given
them. Trainable: {"unet", "image_proj"}; the VAE is never trained.
"""

from __future__ import annotations

from typing import Optional

import torch

from pcdms_tpu_torch.diffusion.ddpm import ddpm_add_noise, ddpm_velocity
from pcdms_tpu_torch.diffusion.schedules import NoiseSchedule, sd21_schedule
from pcdms_tpu_torch.parallel.mesh import draw_rows
from pcdms_tpu_torch.train.stage2 import Draws, _encode, stage2_draws
from pcdms_tpu_torch.utils.tree import cast_tree


def stage3_draws(generator: Optional[torch.Generator], batch_size: int,
                 latent_hw, num_train_timesteps: int = 1000,
                 device=None) -> Draws:
    """The loss's random inputs in the JAX loss's order: ``vae_target`` /
    ``vae_gen`` (B, h, w, 4) posterior noises, ``noise`` (B, h, w, 4),
    ``offset`` (B, 1, 1, 4) and ``timesteps`` (B,)."""
    d = stage2_draws(generator, batch_size, latent_hw, num_train_timesteps,
                     device)
    return {"vae_target": d["vae_gt"], "vae_gen": d["vae_masked"],
            "noise": d["noise"], "offset": d["offset"],
            "timesteps": d["timesteps"]}


def stage3_loss(models, vae, batch, draws: Draws, *,
                schedule: NoiseSchedule, noise_offset: float = 0.1,
                compute_dtype: torch.dtype = torch.bfloat16):
    """Deterministic stage-3 loss. models: {"unet", "image_proj"}; vae: the
    frozen VAE, already in the compute dtype; batch: target_image /
    gen_image (B, H, W, 3) in [-1, 1], dino_features (B, 257, 1536).
    Returns the scalar f32 loss."""
    cd = compute_dtype
    with torch.no_grad():
        latents = _encode(vae, batch["target_image"], draws["vae_target"], cd)
        gen_latents = _encode(vae, batch["gen_image"], draws["vae_gen"], cd)

    noise = draws["noise"]
    if noise_offset != 0.0:
        noise = noise + noise_offset * draws["offset"]
    t = draws["timesteps"]
    noisy = ddpm_add_noise(schedule, latents, noise, t)
    unet_in = torch.cat([noisy, gen_latents], dim=-1).to(cd)
    ctx = models["image_proj"](batch["dino_features"].to(cd))
    pred = models["unet"](unet_in, t, ctx)

    if schedule.prediction_type == "epsilon":
        target = noise
    elif schedule.prediction_type == "v_prediction":
        target = ddpm_velocity(schedule, latents, noise, t)
    else:
        raise ValueError(schedule.prediction_type)
    return torch.mean(torch.square(pred.float() - target))


def stage3_loss_fn(vae, noise_offset: float = 0.1,
                   prediction_type: str = "epsilon",
                   compute_dtype: torch.dtype = torch.bfloat16, mesh=None):
    """loss_fn(models, batch, generator) -> (loss, {}) for
    ``make_train_step``: draws from ``generator`` on the batch's device
    (this rank's rows of the global batch's draws over ``mesh``), then
    ``stage3_loss``. The VAE is cast to the compute dtype once."""
    schedule = sd21_schedule(prediction_type)
    vae = cast_tree(vae, compute_dtype)

    def loss_fn(models, batch, generator):
        img = batch["target_image"]
        draws = draw_rows(lambda n: stage3_draws(
            generator, n, (img.shape[1] // 8, img.shape[2] // 8),
            schedule.num_train_timesteps, img.device), img.shape[0], mesh)
        loss = stage3_loss(models, vae, batch, draws, schedule=schedule,
                           noise_offset=noise_offset,
                           compute_dtype=compute_dtype)
        return loss, {}

    return loss_fn
