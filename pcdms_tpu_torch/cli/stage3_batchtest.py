"""Stage-3 batch test CLI (counterpart of ``pcdms_tpu/cli/stage3_batchtest.py``,
flag-compatible with it). Runs on the CUDA card unless ``--device cpu``.

For every test pair: read the stage-2 output ``{src}_to_{tgt}.png`` from
``--gen_dir``, encode the source with DINOv2, sample
``--num_images_per_prompt`` refinements (20-step UniPC, CFG 2.0 by
default), keep the one with the best SSIM against the ground-truth target
and write it as ``{src}_to_{tgt}.png`` (with ``--grid_output`` also a
[source | stage-2 | refined | target] grid).

    python -m pcdms_tpu_torch.cli.stage3_batchtest --random_init \\
        --json_path test_pairs.json --image_root_path <root> \\
        --gen_dir <stage-2 PNG dir> --save_path out --batch_size 2

Weights: the reference's files (``--weights_name``, the monolithic stage-3
checkpoint; ``--pretrained_model_name_or_path``, SD-2.1's VAE;
``--image_encoder_p_path``, DINOv2-giant; ``compat/load.py``),
``--random_init`` (from ``--seed``), or a port training run's checkpoint
(``--train_ckpt_dir``: unet, image_proj) with the frozen-encoder bundle it
used (``--frozen_dir``: vae, dino).
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from pcdms_tpu_torch.cli.common import (
    build_cli_models, check_weight_flags, device_select_best,
    device_uint8, global_indices, per_item_latents, pretrained_vae_dino,
    process_shard, queue_readback, save_images, setup_logging, tiny_configs,
    wait_readback,
)
from pcdms_tpu_torch.cli.stage2_batchtest import best_of_n_ssim
from pcdms_tpu_torch.data.datasets import pair_stem
from pcdms_tpu_torch.parallel.mesh import make_mesh

logger = logging.getLogger("pcdms_tpu_torch.stage3_batchtest")

_PRETRAINED_FLAGS = ("weights_name", "pretrained_model_name_or_path",
                     "image_encoder_p_path")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--json_path", type=str, required=True)
    p.add_argument("--image_root_path", type=str, default="")
    p.add_argument("--gen_dir", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--weights_name", type=str, default=None,
                   help="monolithic stage-3 checkpoint (.pt)")
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None,
                   help="SD-2.1 model dir (its vae/)")
    p.add_argument("--image_encoder_p_path", type=str, default=None,
                   help="DINOv2-giant dir")
    p.add_argument("--img_width", type=int, default=512)
    p.add_argument("--img_height", type=int, default=512)
    p.add_argument("--num_inference_steps", type=int, default=20)
    p.add_argument("--guidance_scale", type=float, default=2.0)
    p.add_argument("--num_images_per_prompt", type=int, default=4)
    p.add_argument("--scheduler", type=str, default="unipc",
                   choices=["unipc", "ddim"])
    p.add_argument("--batch_size", type=int, default=4,
                   help="pairs per sampler call; the UNet batch is "
                        "batch_size x num_images_per_prompt x 2 (CFG)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--tiny_config", action="store_true",
                   help="tiny-geometry models (CPU smoke runs)")
    p.add_argument("--device_select", action="store_true",
                   help="best-of-N SSIM selection on the device (see "
                        "stage2_batchtest --device_select)")
    p.add_argument("--grid_output", action="store_true",
                   help="also save [source | gen | refined | GT] grids")
    p.add_argument("--train_ckpt_dir", type=str, default=None,
                   help="checkpoint dir of a port stage-3 training run: its "
                        "trained unet, image_proj (EMA if tracked); pair "
                        "with --frozen_dir")
    p.add_argument("--frozen_dir", type=str, default=None,
                   help="frozen-encoder bundle (train/frozen.py) with vae "
                        "and dino")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Exit where the JAX CLI cannot go on (``cli/common.py``)."""
    check_weight_flags(args, _PRETRAINED_FLAGS,
                       "the VAE / DINOv2 the run trained against")


def build_models(args, device):
    """({unet, image_proj, vae} in bf16, dino in bf16) on ``device``."""
    from pcdms_tpu_torch.models.projections import ImageProjModel
    from pcdms_tpu_torch.models.unet2d import (
        UNet2DConditionModel, stage3_unet_config,
    )
    from pcdms_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from pcdms_tpu_torch.models.vit import (
        VisionTransformer, dinov2_giant_config,
    )
    if args.tiny_config:
        tiny = tiny_configs()
        unet_cfg, vae_cfg, dino_cfg = tiny.unet3, tiny.vae, tiny.dino
        proj_kw = tiny.image_proj_kwargs
    else:
        unet_cfg, vae_cfg = stage3_unet_config(), VAEConfig()
        dino_cfg, proj_kw = dinov2_giant_config(), {}
    trainable = {"unet": lambda: UNet2DConditionModel(unet_cfg),
                 "image_proj": lambda: ImageProjModel(**proj_kw)}
    frozen = {"vae": lambda: AutoencoderKL(vae_cfg),
              "dino": lambda: VisionTransformer(dino_cfg)}

    def pretrained():
        from pcdms_tpu_torch.compat.load import load_pcdms_stage3_checkpoint
        weights = load_pcdms_stage3_checkpoint(args.weights_name)
        weights.update(pretrained_vae_dino(args, dino_cfg))
        return weights

    models = {k: m.to(torch.bfloat16) for k, m in build_cli_models(
        args, trainable, frozen, device, pretrained).items()}
    return models, models.pop("dino")


def _u8(x):
    """[-1, 1] floats -> uint8, truncated (the reference's grid panels)."""
    return np.clip((x + 1.0) * 127.5, 0, 255).astype(np.uint8)


def main(argv=None):
    """Run the batch test; returns the paths of the PNGs written."""
    setup_logging()
    args = parse_args(argv)
    check_supported(args)
    mesh = make_mesh(args.device)
    device = mesh.device
    os.makedirs(args.save_path, exist_ok=True)

    from pcdms_tpu_torch.data.datasets import PairList, Stage3Dataset
    from pcdms_tpu_torch.data.preprocess import (
        clip_preprocess, load_image, to_neg1_1,
    )
    from pcdms_tpu_torch.pipelines.stage3_refine import stage3_generate
    from pcdms_tpu_torch.train.encoders import dino_features

    pairs = PairList(args.json_path, args.image_root_path).shard(
        *process_shard(mesh))
    size = (args.img_width, args.img_height)
    helper = Stage3Dataset(pairs, args.gen_dir, size=size)
    models, dino = build_models(args, device)
    items, bs, written = pairs.pairs, args.batch_size, []
    t0 = time.time()

    def finish(pending):
        """Wait for one batch's readback, select, write its PNGs."""
        chunk, readback, host_gen, t_imgs, start = pending
        images, n = wait_readback(*readback), len(chunk)
        for i, item in enumerate(chunk):
            gt = to_neg1_1(t_imgs[i])
            if args.device_select:
                best_img = images[i]
            else:
                cands = images[i::n]
                best_img = cands[best_of_n_ssim(cands, gt)]
            stem = pair_stem(item)
            path = os.path.join(args.save_path, f"{stem}.png")
            save_images(best_img[None], [path])
            written.append(path)
            if args.grid_output:
                src = to_neg1_1(load_image(
                    pairs.image_path(item["source_image"]), size))
                grid = np.concatenate([_u8(src), _u8(host_gen[i]), best_img,
                                       _u8(gt)], axis=1)
                save_images(grid[None], [os.path.join(
                    args.save_path, f"grid_{stem}.png")])
        logger.info("processed %d/%d", min(start + bs, len(items)),
                    len(items))

    pending = None
    for start in range(0, len(items), bs):
        chunk = items[start:start + bs]
        n = len(chunk)
        host_gen = np.stack([to_neg1_1(load_image(helper.gen_path(i), size))
                             for i in chunk])
        t_imgs = [load_image(pairs.image_path(i["target_image"]), size)
                  for i in chunk]
        s_pix = np.stack([
            clip_preprocess(load_image(pairs.image_path(i["source_image"]),
                                       size)) for i in chunk])
        with torch.inference_mode():
            feats = dino_features(dino, s_pix)
            index = global_indices(start, n, mesh)
            latents = per_item_latents(
                args.seed, index, args.num_images_per_prompt,
                (args.img_height // 8, args.img_width // 8, 4))
            images = stage3_generate(
                models, host_gen, feats,
                generator=torch.Generator(device=device).manual_seed(
                    args.seed + index[0]),
                latents=latents, num_steps=args.num_inference_steps,
                guidance_scale=args.guidance_scale,
                scheduler=args.scheduler,
                num_samples=args.num_images_per_prompt, device=device)
            if args.device_select:
                gt_u8 = np.stack([np.asarray(t, np.uint8) for t in t_imgs])
                dev_images, _ = device_select_best(
                    images, gt_u8, args.num_images_per_prompt)
            else:
                dev_images = device_uint8(images)
            batch = (chunk, queue_readback(dev_images), host_gen, t_imgs,
                     start)
        if pending is not None:
            finish(pending)
        pending = batch

    if pending is not None:
        finish(pending)
    logger.info("done in %.1fs", time.time() - t0)
    return written


if __name__ == "__main__":
    main()
