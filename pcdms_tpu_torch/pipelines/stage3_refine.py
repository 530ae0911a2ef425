"""Stage-3 refinement sampler (counterpart of
``pcdms_tpu/pipelines/stage3_refine.py``): an img2img polish of the stage-2
output. The VAE latents of the stage-2 image are concatenated with the
noisy latents (8 channels) and denoised by the stage-3 UNet, conditioned on
the projected DINOv2 features of the source. CFG zeroes both the features
and the gen-latents on the unconditional half, which comes first. DDIM
(ancestral for eta > 0) or UniPC, optionally with encoder propagation; no
LCM, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pcdms_tpu_torch.diffusion.schedules import sd21_schedule
from pcdms_tpu_torch.pipelines.sampling import (
    check_sampler_options, run_sampler, unet_model_eps,
)
from pcdms_tpu_torch.utils.device import resolve_device
from pcdms_tpu_torch.utils.tree import as_tensor, cast_tree


def stage3_generate(models: Dict[str, torch.nn.Module], gen_image,
                    dino_features,
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
                    device=None):
    """Refine stage-2 outputs.

    models: {"unet" (8 input channels), "image_proj", "vae"}, cast to
        ``compute_dtype`` and ``device`` without touching the caller's
        copies.
    gen_image: (B, H, W, 3) stage-2 generated target image in [-1, 1].
    dino_features: (B, 257, 1536) DINOv2 features of the source image.
    generator: draws, in this order, the VAE posterior sample (unless
        deterministic_vae), the initial latents (unless given), and for
        ancestral DDIM (eta > 0) one (B*num_samples, H/8, W/8, 4) f32 normal
        after every step; a generator seeded 0 on ``device`` when None.
    encoder_cache_interval: > 1 runs the UNet's encoder on every
        interval-th step only (``sampling.unet_model_eps``); 1 is exact.
    Inputs may be numpy arrays or tensors. Returns (B*num_samples, H, W, 3)
    f32 images in [-1, 1] (latents if decode=False), sample-major:
    output[i*B + b] is sample i of input b.
    """
    check_sampler_options(scheduler, encoder_cache_interval,
                          models["unet"].cfg, schedulers=("ddim", "unipc"))
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cd = compute_dtype
    use_cfg = guidance_scale > 1.0

    with torch.inference_mode():
        m = cast_tree(models, cd, dev)
        gen_image = as_tensor(gen_image, dev)
        b, img_h, img_w, _ = gen_image.shape
        feature_f = m["image_proj"](as_tensor(dino_features, dev).to(cd))
        gen_latents = m["vae"].encode(
            gen_image.to(cd),
            generator=None if deterministic_vae else generator).float()

        feature_f = torch.cat([feature_f] * num_samples)
        gen_latents = torch.cat([gen_latents] * num_samples)
        n = b * num_samples
        if use_cfg:
            feature_f = torch.cat([torch.zeros_like(feature_f), feature_f])
            gen_latents = torch.cat([torch.zeros_like(gen_latents),
                                     gen_latents])
        gen_d = gen_latents.to(cd)

        def make_inp(x, t):
            lat = torch.cat([x] * 2) if use_cfg else x
            inp = torch.cat([lat.to(cd), gen_d], dim=-1)
            return inp, torch.full((inp.shape[0],), t, dtype=torch.int32,
                                   device=dev)

        model_eps = unet_model_eps(
            m["unet"], make_inp, feature_f,
            encoder_cache_interval=encoder_cache_interval,
            zero_ctx_prefix=n if use_cfg else 0, use_cfg=use_cfg,
            guidance_scale=guidance_scale, guidance_rescale=guidance_rescale)

        if latents is not None:
            x_init = as_tensor(latents, dev).float()
        else:
            x_init = torch.randn((n, img_h // 8, img_w // 8, 4),
                                 generator=generator, dtype=torch.float32,
                                 device=dev)
        out = run_sampler(scheduler, sd21_schedule(), model_eps, x_init,
                          num_steps, generator, eta=eta)
        if not decode:
            return out
        return m["vae"].decode(out.to(cd)).float()
