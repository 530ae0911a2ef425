"""Single-image demo (counterpart of ``examples/demo.py``, with the same
flags plus ``--device``): the simplified stage-2-only release run on one
image, on the CUDA card unless ``--device cpu``.

One monolithic ``pcdms_ckpt.pt`` (the 9-channel UNet without class
embedding, ``pose_proj`` and ``image_proj_model``), SD-2.1's VAE and
DINOv2-giant; 50-step DDIM with CFG 2.0 on a [source | black] 512x1024
canvas conditioned on the target pose's skeleton render and the source's
DINOv2 features. The right half of the canvas is written as a PNG.

    python -m pcdms_tpu_torch.cli.demo \\
        --source person.png --target_pose pose.txt \\
        --ckpt pcdms_ckpt.pt --sd /ckpts/sd21 --dinov2 /ckpts/dinov2-giant \\
        --out result.png

``--random_init`` runs the whole path without checkpoints (weights drawn
from ``--seed``: the output is noise); ``--tiny_config`` shrinks every model
and implies ``--random_init`` (CPU smoke runs: add ``--device cpu --size
64``). ``.pt`` / ``.bin`` files are unpickled: trusted local files only.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source", type=str, required=True,
                   help="source person image")
    p.add_argument("--target_pose", type=str, required=True,
                   help="18-keypoint pose .txt (normalized) OR a rendered "
                        "skeleton image")
    p.add_argument("--source_pose", type=str, default=None,
                   help="source pose .txt/render; omitted -> black")
    p.add_argument("--ckpt", type=str, default=None,
                   help="monolithic pcdms_ckpt.pt")
    p.add_argument("--sd", type=str, default=None, help="SD-2.1 dir (vae)")
    p.add_argument("--dinov2", type=str, default=None)
    p.add_argument("--out", type=str, default="result.png")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=2.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--encoder_cache_interval", type=int, default=1,
                   help=">1 = encoder-propagation speedup (approximate)")
    p.add_argument("--tiny_config", action="store_true",
                   help="tiny model geometry (CPU smoke; implies "
                        "--random_init)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def model_configs(tiny: bool) -> SimpleNamespace:
    """The demo variant's geometry: the stage-2 UNet without class
    embedding, SD-2.1's VAE, DINOv2-giant and the projections' defaults,
    or the tiny configurations (``cli/common.tiny_configs``)."""
    from pcdms_tpu_torch.models.unet2d import stage2_unet_config
    from pcdms_tpu_torch.models.vae import VAEConfig
    from pcdms_tpu_torch.models.vit import dinov2_giant_config
    if tiny:
        from pcdms_tpu_torch.cli.common import tiny_configs
        t = tiny_configs()
        return SimpleNamespace(unet=t.unet2(with_class_embed=False),
                               vae=t.vae, dino=t.dino,
                               image_proj=t.image_proj_kwargs,
                               pose_proj=t.pose_proj_kwargs)
    return SimpleNamespace(unet=stage2_unet_config(with_class_embed=False),
                           vae=VAEConfig(), dino=dinov2_giant_config(),
                           image_proj={}, pose_proj={})


def build_models(args, cfg, device):
    """({unet, image_proj, pose_proj, vae}, dino) on ``device`` in eval
    mode, f32: drawn from ``args.seed`` in that order (``--random_init``),
    or loaded from ``--ckpt`` / ``--sd`` / ``--dinov2`` (``compat/load.py``;
    DINOv2's position embeddings resized to ``cfg.dino``'s grid)."""
    from pcdms_tpu_torch.models.projections import (
        ImageProjModel, PoseCondEmbedding,
    )
    from pcdms_tpu_torch.models.unet2d import UNet2DConditionModel
    from pcdms_tpu_torch.models.vae import AutoencoderKL
    from pcdms_tpu_torch.models.vit import VisionTransformer

    builders = {
        "unet": lambda: UNet2DConditionModel(cfg.unet),
        "image_proj": lambda: ImageProjModel(**cfg.image_proj),
        "pose_proj": lambda: PoseCondEmbedding(**cfg.pose_proj),
        "vae": lambda: AutoencoderKL(cfg.vae),
        "dino": lambda: VisionTransformer(cfg.dino),
    }
    with torch.device(device):
        if args.random_init:
            torch.manual_seed(args.seed)
            models = {name: build() for name, build in builders.items()}
        else:
            from pcdms_tpu_torch.compat.load import (
                load_dinov2, load_into, load_pcdms_stage2_checkpoint,
                load_sd_vae,
            )
            grid = cfg.dino.image_size // cfg.dino.patch_size
            weights = load_pcdms_stage2_checkpoint(args.ckpt)
            weights["vae"] = load_sd_vae(args.sd)
            weights["dino"] = load_dinov2(args.dinov2,
                                          target_grid=(grid, grid))
            models = {name: load_into(build(), weights.pop(name), name)
                      for name, build in builders.items()}
    models = {k: m.eval() for k, m in models.items()}
    return models, models.pop("dino")


def load_pose_canvas(path, size):
    """Accept a keypoint .txt (rendered here) or a pre-rendered image ->
    (size, size, 3) f32 in [-1, 1]; None -> black."""
    from pcdms_tpu_torch.data.preprocess import load_image, to_neg1_1
    from pcdms_tpu_torch.pose.keypoints import read_pose_txt
    from pcdms_tpu_torch.pose.skeleton import render_pose

    if path is None:
        return np.full((size, size, 3), -1.0, np.float32)
    if path.endswith(".txt"):
        coords = read_pose_txt(path).reshape(18, 2)
        render = render_pose(coords, size, size)
        return render.astype(np.float32) / 127.5 - 1.0
    return to_neg1_1(load_image(path, (size, size)))


def demo_inputs(source, source_pose, target_pose, size):
    """-> (the [source | black] canvas (H, 2W, 3), the [source pose |
    target pose] canvas, DINOv2's (224, 224, 3) input of the source), as
    the JAX demo builds them."""
    from pcdms_tpu_torch.data.preprocess import (
        clip_preprocess, load_image, to_neg1_1,
    )
    s_img = load_image(source, (size, size))
    canvas = np.concatenate(
        [to_neg1_1(s_img), np.full((size, size, 3), -1.0, np.float32)],
        axis=1)
    pose_canvas = np.concatenate(
        [load_pose_canvas(source_pose, size),
         load_pose_canvas(target_pose, size)], axis=1)
    return canvas, pose_canvas, clip_preprocess(s_img)


def generate(models, dino, canvas, pose_canvas, dino_pixels, *, steps,
             guidance_scale, encoder_cache_interval, generator,
             latents=None, compute_dtype=torch.bfloat16,
             deterministic_vae=False, device=None):
    """DINOv2 features of the source, then ``stage2_generate`` (DDIM, no
    class embedding) -> the (1, H, 2W, 3) f32 canvas in [-1, 1]."""
    from pcdms_tpu_torch.pipelines.stage2_inpaint import stage2_generate
    from pcdms_tpu_torch.train.encoders import dino_features
    feats = dino_features(dino, dino_pixels[None], compute_dtype)
    return stage2_generate(
        models, canvas[None], pose_canvas[None], feats, None,
        generator=generator, latents=latents, num_steps=steps,
        guidance_scale=guidance_scale, scheduler="ddim",
        compute_dtype=compute_dtype,
        encoder_cache_interval=encoder_cache_interval,
        deterministic_vae=deterministic_vae, device=device)


def main(argv=None):
    """Run the demo; returns the path of the PNG written."""
    from pcdms_tpu_torch.cli.common import save_images
    from pcdms_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.tiny_config:
        args.random_init = True
    if not args.random_init:
        missing = [f for f in ("ckpt", "sd", "dinov2")
                   if getattr(args, f) is None]
        if missing:
            raise SystemExit(
                "the checkpoint path(s) --" + " --".join(missing)
                + " are required without --random_init (pass "
                "--random_init for a weight-free smoke run)")
    cfg = model_configs(args.tiny_config)
    models, dino = build_models(args, cfg, device)
    # bf16 once here, so stage2_generate's cast copies nothing
    models = {k: m.to(torch.bfloat16) for k, m in models.items()}
    dino = dino.to(torch.bfloat16)
    canvas, pose_canvas, dino_pixels = demo_inputs(
        args.source, args.source_pose, args.target_pose, args.size)
    images = generate(
        models, dino, canvas, pose_canvas, dino_pixels, steps=args.steps,
        guidance_scale=args.guidance_scale,
        encoder_cache_interval=args.encoder_cache_interval,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    # right half = generated target
    save_images(images[:, :, args.size:, :], [args.out])
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
