"""The PCDMs stage-3 refinement model: the same SD-2.1 UNet with 8 input
channels and no class embedding, the SD VAE and the image projection
(``stage3_generate``). A request is a stage-2 image and the source's
DINOv2 features, made on the device from its seed; its initial latents
are the ``[seed, 3]`` substream of the serving contract.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import flops
from benchmark.families import pcdms_stage2 as s2
from benchmark.reference import sampling as ref_sampling

NETS = ("unet", "vae", "image_proj")


def program_models(cfg: dict, seed: int, device) -> dict:
    return s2.program_models(cfg, seed, device, NETS)


def reference_models(cfg: dict, seed: int, device,
                     precision: str = "f32") -> dict:
    return s2.reference_models(cfg, seed, device, precision, NETS)


def row_latents(cfg: dict, row_seed: int) -> np.ndarray:
    h, w = cfg["canvas"]
    return np.random.default_rng([int(row_seed), 3]).standard_normal(
        (h // 8, w // 8, 4), dtype=np.float32)


def make_rows(cfg: dict, row_seeds, device) -> dict:
    h, w = cfg["canvas"]
    rows = []
    for s in row_seeds:
        gen = torch.Generator(device=device).manual_seed(int(s))
        rows.append({
            "gen_image": s2.smooth_image(gen, 1, h, w, device),
            "dino": torch.randn((1, cfg["dino_tokens"], cfg["dino_dim"]),
                                generator=gen, device=device),
            "latents": torch.from_numpy(row_latents(cfg, s))[None].to(device),
        })
    return {k: torch.cat([r[k] for r in rows]) for k in rows[0]}


def generate(models: dict, rows: dict, p: dict, device):
    from pcdms_tpu_torch.pipelines import stage3_refine
    return stage3_refine.stage3_generate(
        models, rows["gen_image"], rows["dino"], latents=rows["latents"],
        num_steps=p["num_steps"], guidance_scale=p["guidance_scale"],
        scheduler=p["scheduler"],
        compute_dtype=next(models["unet"].parameters()).dtype,
        deterministic_vae=True, device=device)


def reference_row(nets: dict, rows: dict, i: int, p: dict):
    row = {k: v[i:i + 1].float() for k, v in rows.items()}
    with ref_sampling.full_f32():
        return ref_sampling.stage3_one(nets, row, row["latents"],
                                       p["num_steps"], p["guidance_scale"])[0]


def work(cfg: dict, n: int, p: dict) -> int:
    h, w = cfg["canvas"]
    cfg_rows = 2 if p["guidance_scale"] > 1.0 else 1
    return (flops.image_proj(cfg["image_proj"], n, cfg["dino_tokens"])
            + flops.vae_encode(cfg["vae"], n, h, w)
            + p["num_steps"] * flops.unet(cfg["unet"], cfg_rows * n, h // 8,
                                          w // 8, cfg["dino_tokens"],
                                          cross_rows=n)
            + flops.vae_decode(cfg["vae"], n, h // 8, w // 8))
