"""Stage-1 prior sampler (counterpart of
``pcdms_tpu/pipelines/stage1_prior.py``): UnCLIP ancestral sampling over
the target image's CLIP embedding, with 'sample' prediction, x0 clipped to
+/- 10 and the result un-normalised by the CLIP stats. CFG (the batch test
runs guidance 0) zeroes the pose tokens and the source embedding on the
unconditional half, which comes first.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pcdms_tpu_torch.diffusion.guidance import apply_cfg
from pcdms_tpu_torch.diffusion.schedules import prior_schedule
from pcdms_tpu_torch.diffusion.unclip import (
    unclip_clip_x0, unclip_step_tables,
)
from pcdms_tpu_torch.models.prior_transformer import (
    PriorConfig, prior_post_process_latents,
)
from pcdms_tpu_torch.pipelines.sampling import row_generators, row_randn
from pcdms_tpu_torch.utils.device import resolve_device
from pcdms_tpu_torch.utils.tree import as_tensor, cast_tree

# the stage tag of the stage-1 streams under ``seeds=``
STAGE1_TAG = 0


def stage1_generate(models: Dict[str, torch.nn.Module], s_embed, s_pose,
                    t_pose, generator: Optional[torch.Generator] = None,
                    latents=None, seeds=None, *,
                    prior_cfg: Optional[PriorConfig] = None,
                    num_steps: int = 20,
                    guidance_scale: float = 0.0,
                    compute_dtype: torch.dtype = torch.float32,
                    device=None):
    """Predict target CLIP image embeddings.

    models: {"prior": PriorTransformer}, cast to ``compute_dtype`` and
        ``device`` without touching the caller's copy.
    s_embed: (B, E) source image CLIP embedding; s_pose / t_pose: (B, 36)
        normalised keypoints. Numpy arrays or tensors.
    prior_cfg: optional, must equal the module's own config.
    generator: draws, in this order, the initial latents (unless
        ``latents`` is given) and then one (B, E) normal per step (the last
        step's is multiplied by 0); a generator seeded 0 on ``device`` when
        None.
    seeds: optional (B,) ints. Each row then draws the same sequence from
        its own generator (``pipelines/sampling.row_generators``, stage tag
        0), so row i's trajectory depends on its own inputs and seed only,
        not on the batch around it. The streams are torch's, not the JAX
        package's threefry ones: a seed gives other numbers there.
    Returns (B, E) f32 predicted target embeddings (un-normalised).
    """
    prior = models["prior"]
    if prior_cfg is not None and prior_cfg != prior.cfg:
        raise ValueError(f"prior_cfg {prior_cfg} is not the module's "
                         f"{prior.cfg}")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cd = compute_dtype
    use_cfg = guidance_scale > 1.0
    ts, cx0, cxt, std = unclip_step_tables(prior_schedule(), num_steps)

    with torch.inference_mode():
        prior = cast_tree(prior, cd, dev)
        s_embed = as_tensor(s_embed, dev).to(cd)
        s_pose = as_tensor(s_pose, dev).to(cd)
        t_pose = as_tensor(t_pose, dev).to(cd)
        b, e = s_embed.shape
        proj = (torch.cat([torch.zeros_like(s_embed), s_embed]) if use_cfg
                else s_embed)
        gens = (row_generators(seeds, STAGE1_TAG, dev) if seeds is not None
                else None)

        def noise():
            if gens is not None:
                return row_randn(gens, (e,), dev)
            return torch.randn((b, e), generator=generator,
                               dtype=torch.float32, device=dev)

        x = (as_tensor(latents, dev).float() if latents is not None
             else noise())
        for i in range(num_steps):
            lat = torch.cat([x] * 2) if use_cfg else x
            tt = torch.full((lat.shape[0],), int(ts[i]), dtype=torch.int32,
                            device=dev)
            pred = prior(lat.to(cd), tt, proj, s_pose, t_pose,
                         cfg_zero_cond=use_cfg).float()
            if use_cfg:
                pred = apply_cfg(pred, guidance_scale)
            x = (float(cx0[i]) * unclip_clip_x0(pred) + float(cxt[i]) * x
                 + float(std[i]) * noise())
        return prior_post_process_latents(x)
