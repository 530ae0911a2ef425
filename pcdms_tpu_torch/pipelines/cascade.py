"""The three-stage cascade, prior -> inpaint -> refine (counterpart of
``pcdms_tpu/pipelines/cascade.py``). The reference chains the stages
through files on disk (.npy embeddings, then PNGs); here every
intermediate tensor stays on the device, from (source embedding, poses,
canvases, DINOv2 features) to the refined target image.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pcdms_tpu_torch.pipelines.sampling import row_generators, row_randn
from pcdms_tpu_torch.pipelines.stage1_prior import stage1_generate
from pcdms_tpu_torch.pipelines.stage2_inpaint import stage2_generate
from pcdms_tpu_torch.pipelines.stage3_refine import stage3_generate
from pcdms_tpu_torch.utils.device import resolve_device

Models = Dict[str, torch.nn.Module]


def cascade_generate(stage1_models: Models, stage2_models: Models,
                     stage3_models: Models, s_embed, s_pose_coords,
                     t_pose_coords, vae_image, st_pose_image, dino_feats,
                     generator: Optional[torch.Generator] = None,
                     seeds=None, s1_latents=None, s2_latents=None,
                     s3_latents=None, *,
                     prior_steps: int = 20,
                     inpaint_steps: int = 20,
                     refine_steps: int = 20,
                     guidance_scale: float = 2.0,
                     scheduler: str = "unipc",
                     compute_dtype: torch.dtype = torch.bfloat16,
                     encoder_cache_interval: int = 1,
                     device=None):
    """Run prior -> inpaint -> refine.

    stage1_models: {"prior"}; stage2_models: {"unet", "image_proj",
        "pose_proj", "vae"}; stage3_models: {"unet", "image_proj", "vae"}.
    s_embed: (B, E) source CLIP embedding; s_pose_coords / t_pose_coords:
        (B, 36) keypoints (stage 1).
    vae_image: (B, H, 2W, 3) [source | black] canvas; st_pose_image:
        (B, H, 2W, 3) skeleton canvas (stage 2).
    dino_feats: (B, 257, 1536) source DINOv2 features (stages 2 and 3).
    generator: without ``seeds``, the one stream every stage draws from in
        turn (stage 1's draws, then stage 2's, then stage 3's); a generator
        seeded 0 on ``device`` when None.
    seeds: optional (B,) ints. Every draw is then made per row from its
        seed: stage 1's through ``stage1_generate(seeds=...)``, the initial
        latents of stages 2 and 3 from the streams of stage tags 2 and 3
        (``pipelines/sampling.row_generators``), and both VAE encodes take
        the posterior mean. Row i's output then depends on its own inputs
        and seed only, not on the batch around it. torch streams, not the
        JAX package's threefry ones.
    s1_latents / s2_latents / s3_latents: optional explicit initial latents
        ((B, E), (B, H/8, 2W/8, 4) and (B, H/8, W/8, 4)) in place of the
        seed-derived ones; they require ``seeds``.
    Stage 1 runs in f32 with guidance 0; stages 2 and 3 in
    ``compute_dtype``. Returns {"embeds": (B, E), "inpainted": (B, H, 2W,
    3) full canvas, "refined": (B, H, W, 3) the refined target half}.
    """
    given = [s1_latents, s2_latents, s3_latents]
    if any(x is not None for x in given) and seeds is None:
        raise ValueError("explicit s1/s2/s3 latents require seeds= (the "
                         "other stage-1 draws are seed-derived)")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    deterministic = seeds is not None
    if deterministic:
        _, h, w2, _ = vae_image.shape
        if s2_latents is None:
            s2_latents = row_randn(row_generators(seeds, 2, dev),
                                   (h // 8, w2 // 8, 4), dev)
        if s3_latents is None:
            s3_latents = row_randn(row_generators(seeds, 3, dev),
                                   (h // 8, w2 // 16, 4), dev)

    embeds = stage1_generate(
        stage1_models, s_embed, s_pose_coords, t_pose_coords, generator,
        latents=s1_latents, seeds=seeds, num_steps=prior_steps,
        guidance_scale=0.0, device=dev)
    inpainted = stage2_generate(
        stage2_models, vae_image, st_pose_image, dino_feats,
        embeds[:, None, :], generator, latents=s2_latents,
        num_steps=inpaint_steps, guidance_scale=guidance_scale,
        scheduler=scheduler, compute_dtype=compute_dtype,
        encoder_cache_interval=encoder_cache_interval,
        deterministic_vae=deterministic, device=dev)
    # the right half of the canvas is the generated target
    target = inpainted[:, :, inpainted.shape[2] // 2:, :]
    refined = stage3_generate(
        stage3_models, target, dino_feats, generator, latents=s3_latents,
        num_steps=refine_steps, guidance_scale=guidance_scale,
        scheduler=scheduler, compute_dtype=compute_dtype,
        encoder_cache_interval=encoder_cache_interval,
        deterministic_vae=deterministic, device=dev)
    return {"embeds": embeds, "inpainted": inpainted, "refined": refined}
