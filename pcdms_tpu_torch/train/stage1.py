"""Stage-1 prior training loss (counterpart of
``pcdms_tpu/train/stage1.py``).

  * DDPM on the squaredcos_cap_v2 schedule, ``prediction_type='sample'``;
  * the target CLIP embedding normalised by the CLIP statistics before
    q-sampling;
  * the noise offset on the embedding noise;
  * MSE between the predicted and the clean normalised embedding.

As in the JAX package, the frozen CLIP encoder runs outside the loss (on
the fly in the batch generator, or from the embedding cache), and condition
dropout zeroes pixels and coordinates in the data layer, so the null
condition is the zero-image embedding. ``stage1_draws`` makes the three
random inputs (noise, offset, timesteps) from a ``torch.Generator`` and
``stage1_loss`` is deterministic given them. Trainable: {"prior"}.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pcdms_tpu_torch.diffusion.ddpm import (
    ddpm_add_noise, offset_shape, sample_timesteps,
)
from pcdms_tpu_torch.diffusion.schedules import NoiseSchedule, prior_schedule
from pcdms_tpu_torch.models.prior_transformer import prior_normalize_embeds
from pcdms_tpu_torch.parallel.mesh import draw_rows

Draws = Dict[str, torch.Tensor]


def stage1_draws(generator: Optional[torch.Generator], batch_size: int,
                 embedding_dim: int, num_train_timesteps: int = 1000,
                 device=None) -> Draws:
    """``noise`` (B, E) and ``offset`` (B, 1) f32 standard normals and
    ``timesteps`` (B,), in the JAX loss's order."""
    noise = torch.randn((batch_size, embedding_dim), generator=generator,
                        device=device)
    return {
        "noise": noise,
        "offset": torch.randn(offset_shape(noise), generator=generator,
                              device=device),
        "timesteps": sample_timesteps(generator, batch_size,
                                      num_train_timesteps, device),
    }


def stage1_loss(models, batch, draws: Draws, *, schedule: NoiseSchedule,
                noise_offset: float = 0.1,
                compute_dtype: torch.dtype = torch.float32):
    """Deterministic stage-1 loss. models: {"prior"}; batch: s_embed /
    t_embed (B, E) raw CLIP embeddings, s_pose / t_pose (B, 36). Returns
    the scalar f32 loss."""
    cd = compute_dtype
    x0 = prior_normalize_embeds(batch["t_embed"].float())
    noise = draws["noise"]
    if noise_offset != 0.0:
        noise = noise + noise_offset * draws["offset"]
    t = draws["timesteps"]
    x_t = ddpm_add_noise(schedule, x0, noise, t)
    pred = models["prior"](x_t.to(cd), t, batch["s_embed"].to(cd),
                           batch["s_pose"].to(cd), batch["t_pose"].to(cd))
    return torch.mean(torch.square(pred.float() - x0))


def stage1_loss_fn(noise_offset: float = 0.1,
                   compute_dtype: torch.dtype = torch.float32, mesh=None):
    """loss_fn(models, batch, generator) -> (loss, {}) for
    ``make_train_step``: draws from ``generator`` on the batch's device
    (this rank's rows of the global batch's draws over ``mesh``), then
    ``stage1_loss``."""
    schedule = prior_schedule()

    def loss_fn(models, batch, generator):
        emb = batch["t_embed"]
        draws = draw_rows(lambda n: stage1_draws(
            generator, n, emb.shape[1], schedule.num_train_timesteps,
            emb.device), emb.shape[0], mesh)
        loss = stage1_loss(models, batch, draws, schedule=schedule,
                           noise_offset=noise_offset,
                           compute_dtype=compute_dtype)
        return loss, {}

    return loss_fn
