"""Stage-2 pose-conditioned inpainting sampler (counterpart of
``pcdms_tpu/pipelines/stage2_inpaint.py``).

VAE encode of the [source | black] canvas, the [ones | zeros] half mask,
the pose encoder, the DINOv2-feature projection, a CFG-doubled denoising
loop (DDIM, ancestral DDIM or UniPC, optionally with encoder propagation;
or LCM on a w-conditioned student) over the 9-channel UNet, and VAE decode.

Conditioning layout (as the reference's):
  * UNet input: concat([noisy_latents, mask, masked_latents]) = 9 channels
  * cross-attention tokens: [proj(DINOv2 257 x 1536 -> 1024), target CLIP
    embedding] = 258 tokens (257 in the demo variant); the CFG negative is
    zeros and comes first
  * class_labels (full variant): the target CLIP embedding
  * pose: skeleton render -> 320-channel map added after conv_in; not
    dropped for CFG (duplicated for both halves)
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pcdms_tpu_torch.diffusion.schedules import sd21_schedule
from pcdms_tpu_torch.nn.layers import guidance_scale_embedding
from pcdms_tpu_torch.pipelines.sampling import (
    check_sampler_options, run_sampler, unet_model_eps,
)
from pcdms_tpu_torch.utils.device import resolve_device
from pcdms_tpu_torch.utils.tree import as_tensor, cast_tree


def build_half_mask(batch: int, latent_h: int, latent_w: int, dtype,
                    device=None):
    """[ones | zeros] latent mask, (B, h, w, 1): source (left) half = 1."""
    half = latent_w // 2
    mask = torch.zeros((batch, latent_h, latent_w, 1), dtype=dtype,
                       device=device)
    mask[:, :, :half] = 1
    return mask


def stage2_generate(models: Dict[str, torch.nn.Module], vae_image, st_pose,
                    dino_features, pred_t_embed,
                    generator: Optional[torch.Generator] = None,
                    latents=None, *,
                    num_steps: int = 20,
                    guidance_scale: float = 2.0,
                    guidance_rescale: float = 0.0,
                    scheduler: str = "unipc",
                    num_samples: int = 1,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    decode: bool = True,
                    eta: float = 0.0,
                    encoder_cache_interval: int = 1,
                    deterministic_vae: bool = False,
                    lcm_origin_steps: int = 50,
                    device=None):
    """Generate target-pose images.

    models: {"unet", "image_proj", "pose_proj", "vae"} modules; cast to
        ``compute_dtype`` and ``device`` without touching the caller's
        copies (``cast_tree``).
    vae_image: (B, H, 2W, 3) [source | black] canvas in [-1, 1].
    st_pose: (B, H, 2W, 3) [source pose | target pose] skeleton render.
    dino_features: (B, 257, 1536) DINOv2 last_hidden_state of the source.
    pred_t_embed: (B, 1, 1024) stage-1 target CLIP embedding, or None for
        the demo variant (no class embedding).
    generator: draws, in this order, the VAE posterior sample (unless
        deterministic_vae), the initial latents (unless given), and one
        (B*num_samples, H/8, 2W/8, 4) f32 normal per step where the sampler
        adds noise (ancestral DDIM, eta > 0: after every step; LCM: after
        every step but the last); a fresh generator seeded 0 on ``device``
        when None. torch streams, not the JAX package's threefry ones.
    scheduler: "unipc", "ddim" (ancestral for eta > 0) or "lcm" (a
        w-conditioned student, ``UNetConfig.time_cond_proj_dim``, on the
        boundary grid of ``lcm_origin_steps``). A w-conditioned UNet gets
        the guidance scale through its embedding and no CFG doubling, under
        every scheduler.
    encoder_cache_interval: > 1 runs the UNet's encoder on every
        interval-th step only (``sampling.unet_model_eps``); 1 is exact.
    Inputs may be numpy arrays or tensors. Returns (B*num_samples, H, 2W, 3)
    f32 images in [-1, 1] (latents if decode=False), sample-major:
    output[i*B + b] is sample i of input b.
    """
    unet_cfg = models["unet"].cfg
    check_sampler_options(scheduler, encoder_cache_interval, unet_cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cd = compute_dtype
    # the LCM student embeds the guidance scale: no CFG doubling
    lcm_mode = unet_cfg.time_cond_proj_dim is not None
    use_cfg = guidance_scale > 1.0 and not lcm_mode

    with torch.inference_mode():
        m = cast_tree(models, cd, dev)
        vae_image = as_tensor(vae_image, dev)
        b, img_h, img_w, _ = vae_image.shape
        lh, lw = img_h // 8, img_w // 8

        # --- conditions (computed once, outside the loop) ---
        proj_f = m["image_proj"](as_tensor(dino_features, dev).to(cd))
        if pred_t_embed is not None:
            embed = as_tensor(pred_t_embed, dev).to(cd)
            feature_f = torch.cat([proj_f, embed], dim=1)      # (B, 258, D)
            class_labels = embed[:, 0, :]
        else:
            feature_f, class_labels = proj_f, None
        pose_cond = m["pose_proj"](as_tensor(st_pose, dev).to(cd))
        masked_latents = m["vae"].encode(
            vae_image.to(cd),
            generator=None if deterministic_vae else generator).float()
        mask = build_half_mask(b, lh, lw, torch.float32, dev)

        # --- replicate for num_samples (sample-major) ---
        def tile(x):
            return None if x is None else torch.cat([x] * num_samples, 0)

        feature_f, class_labels, pose_cond = (
            tile(feature_f), tile(class_labels), tile(pose_cond))
        masked_latents, mask = tile(masked_latents), tile(mask)
        n = b * num_samples

        # --- CFG doubling: zero image features first, pose kept ---
        if use_cfg:
            feature_f = torch.cat([torch.zeros_like(feature_f), feature_f])
            if class_labels is not None:
                class_labels = torch.cat(
                    [torch.zeros_like(class_labels), class_labels])
            pose_cond = torch.cat([pose_cond] * 2)
            mask = torch.cat([mask] * 2)
            masked_latents = torch.cat([masked_latents] * 2)
        mask_d, masked_d = mask.to(cd), masked_latents.to(cd)
        timestep_cond = None
        if lcm_mode:
            timestep_cond = guidance_scale_embedding(
                torch.full((n,), guidance_scale, dtype=torch.float32,
                           device=dev), unet_cfg.time_cond_proj_dim).to(cd)

        def make_inp(x, t):
            lat = torch.cat([x] * 2) if use_cfg else x
            inp = torch.cat([lat.to(cd), mask_d, masked_d], dim=-1)
            return inp, torch.full((inp.shape[0],), t, dtype=torch.int32,
                                   device=dev)

        model_eps = unet_model_eps(
            m["unet"], make_inp, feature_f,
            encoder_cache_interval=encoder_cache_interval,
            zero_ctx_prefix=n if use_cfg else 0, use_cfg=use_cfg,
            guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
            class_labels=class_labels, pose_cond=pose_cond,
            timestep_cond=timestep_cond)

        if latents is not None:
            x_init = as_tensor(latents, dev).float()
        else:
            x_init = torch.randn((n, lh, lw, 4), generator=generator,
                                 dtype=torch.float32, device=dev)
        out = run_sampler(scheduler, sd21_schedule(), model_eps, x_init,
                          num_steps, generator, eta=eta,
                          lcm_origin_steps=lcm_origin_steps)
        if not decode:
            return out
        return m["vae"].decode(out.to(cd)).float()
