"""Stage-2 inpainting UNet training loss (counterpart of
``pcdms_tpu/train/stage2.py``).

  * VAE-encode the GT [source | target] canvas and the [source | black]
    masked canvas with the frozen VAE (no grad, compute dtype, posterior
    sample);
  * latent half mask [ones | zeros] and the 9-channel input
    [noisy, mask, masked_latents];
  * UNet with class_labels = the target CLIP embedding, cross-attention
    tokens [proj(DINOv2 features), target CLIP embedding], pose map added
    at conv_in;
  * epsilon (or v) MSE with the noise offset.

The loss is split in two: ``stage2_draws`` makes its five random inputs
from a ``torch.Generator`` (two VAE posterior noises, the noise, the offset
shift, the timesteps) and ``stage2_loss`` is deterministic given them, so a
test can hand it the JAX package's own draws. Trainable: {"unet",
"image_proj", "pose_proj"}; the VAE is passed separately and never trained.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pcdms_tpu_torch.diffusion.ddpm import (
    ddpm_add_noise, ddpm_velocity, offset_shape, sample_timesteps,
)
from pcdms_tpu_torch.diffusion.schedules import NoiseSchedule, sd21_schedule
from pcdms_tpu_torch.parallel.mesh import draw_rows
from pcdms_tpu_torch.pipelines.stage2_inpaint import build_half_mask
from pcdms_tpu_torch.utils.tree import cast_tree

Draws = Dict[str, torch.Tensor]


def stage2_draws(generator: Optional[torch.Generator], batch_size: int,
                 latent_hw, num_train_timesteps: int = 1000,
                 device=None) -> Draws:
    """The loss's random inputs, f32 standard normals and int timesteps:
    ``vae_gt`` / ``vae_masked`` (B, h, w, 4) posterior noises, ``noise``
    (B, h, w, 4), ``offset`` (B, 1, 1, 4) and ``timesteps`` (B,)."""
    shape = (batch_size, *latent_hw, 4)

    def normal(s):
        return torch.randn(s, generator=generator, device=device)

    noise_gt, noise_masked, noise = normal(shape), normal(shape), normal(shape)
    return {
        "vae_gt": noise_gt,
        "vae_masked": noise_masked,
        "noise": noise,
        "offset": normal(offset_shape(noise)),
        "timesteps": sample_timesteps(generator, batch_size,
                                      num_train_timesteps, device),
    }


def _encode(vae, image, noise, dtype):
    """Scaled posterior sample mean + std * noise (``vae_encode``), f32."""
    mean, logvar = vae.encode_moments(image.to(dtype))
    z = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
    return (z * vae.cfg.scaling_factor).float()


def stage2_loss(models, vae, batch, draws: Draws, *,
                schedule: NoiseSchedule, noise_offset: float = 0.1,
                compute_dtype: torch.dtype = torch.bfloat16):
    """Deterministic stage-2 loss. models: {"unet", "image_proj",
    "pose_proj"}; vae: the frozen VAE, already in the compute dtype; batch:
    st_image / masked_image / pose_image (B, H, 2W, 3) in [-1, 1],
    dino_features (B, 257, 1536), clip_embed (B, 1, 1024). Returns the
    scalar f32 loss."""
    cd = compute_dtype
    with torch.no_grad():
        latents = _encode(vae, batch["st_image"], draws["vae_gt"], cd)
        masked = _encode(vae, batch["masked_image"], draws["vae_masked"], cd)
    b, lh, lw, _ = latents.shape
    mask = build_half_mask(b, lh, lw, torch.float32, latents.device)

    noise = draws["noise"]
    if noise_offset != 0.0:
        noise = noise + noise_offset * draws["offset"]
    t = draws["timesteps"]
    noisy = ddpm_add_noise(schedule, latents, noise, t)
    unet_in = torch.cat([noisy, mask, masked], dim=-1).to(cd)

    proj_f = models["image_proj"](batch["dino_features"].to(cd))
    clip_embed = batch["clip_embed"].to(cd)
    ctx = torch.cat([proj_f, clip_embed], dim=1)
    pose_cond = models["pose_proj"](batch["pose_image"].to(cd))
    pred = models["unet"](unet_in, t, ctx, class_labels=clip_embed[:, 0, :],
                          pose_cond=pose_cond)

    if schedule.prediction_type == "epsilon":
        target = noise
    elif schedule.prediction_type == "v_prediction":
        target = ddpm_velocity(schedule, latents, noise, t)
    else:
        raise ValueError(schedule.prediction_type)
    return torch.mean(torch.square(pred.float() - target))


def stage2_loss_fn(vae, noise_offset: float = 0.1,
                   prediction_type: str = "epsilon",
                   compute_dtype: torch.dtype = torch.bfloat16, mesh=None):
    """loss_fn(models, batch, generator) -> (loss, {}) for
    ``make_train_step``: draws from ``generator`` on the batch's device
    (this rank's rows of the global batch's draws over ``mesh``), then
    ``stage2_loss``. The VAE is cast to the compute dtype once (the
    caller's module is left as it is)."""
    schedule = sd21_schedule(prediction_type)
    vae = cast_tree(vae, compute_dtype)

    def loss_fn(models, batch, generator):
        st = batch["st_image"]
        draws = draw_rows(lambda n: stage2_draws(
            generator, n, (st.shape[1] // 8, st.shape[2] // 8),
            schedule.num_train_timesteps, st.device), st.shape[0], mesh)
        loss = stage2_loss(models, vae, batch, draws, schedule=schedule,
                           noise_offset=noise_offset,
                           compute_dtype=compute_dtype)
        return loss, {}

    return loss_fn
