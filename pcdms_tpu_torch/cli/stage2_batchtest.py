"""Stage-2 batch test CLI (counterpart of ``pcdms_tpu/cli/stage2_batchtest.py``,
flag-compatible with it). Runs on the CUDA card unless ``--device cpu``.

For every test pair: build the [source | black] canvas and the
[source pose | target pose] skeleton canvas, encode the source with DINOv2,
sample ``--num_images_per_prompt`` candidates (20-step UniPC, CFG 2.0 by
default), keep the right-half crop with the best SSIM against the ground
truth target, and write it as ``{src}_to_{tgt}.png``.

    python -m pcdms_tpu_torch.cli.stage2_batchtest --random_init \\
        --json_path test_pairs.json --image_root_path <root> \\
        --prior_embeds_dir <stage-1 .npy dir> --save_path out --batch_size 2

Conditioning follows the reference: if the json file name starts with
'train', the target's own CLIP ViT-H embedding is used; otherwise the
stage-1 ``.npy`` predictions come from ``--prior_embeds_dir``.
``--simple_variant`` (no class embedding) needs neither.

Weights: the reference's files (``--weights_name``, the monolithic stage-2
checkpoint; ``--pretrained_model_name_or_path``, SD-2.1's VAE;
``--image_encoder_p_path``, DINOv2-giant; ``--image_encoder_g_path``, CLIP
ViT-H for train mode; ``compat/load.py``), ``--random_init`` (from
``--seed``), or a port training run's checkpoint (``--train_ckpt_dir``)
with the frozen-encoder bundle it used (``--frozen_dir``: vae, dino, and
clip for train mode). One process drives one card; under ``torchrun
--nproc_per_node N`` each rank takes every N-th pair (``parallel/mesh.py``)
and writes its own pairs' PNGs, the same files a single process writes.
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
from pcdms_tpu_torch.data.datasets import pair_stem
from pcdms_tpu_torch.parallel.mesh import make_mesh

logger = logging.getLogger("pcdms_tpu_torch.stage2_batchtest")

# the files pretrained loading reads (and --image_encoder_g_path in train
# mode)
_PRETRAINED_FLAGS = ("weights_name", "pretrained_model_name_or_path",
                     "image_encoder_p_path")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--json_path", type=str, required=True)
    p.add_argument("--image_root_path", type=str, default="")
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--weights_name", type=str, default=None,
                   help="monolithic stage-2 checkpoint (.pt)")
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None,
                   help="SD-2.1 model dir (its vae/)")
    p.add_argument("--image_encoder_p_path", type=str, default=None,
                   help="DINOv2-giant dir")
    p.add_argument("--image_encoder_g_path", type=str, default=None,
                   help="CLIP ViT-H dir (train-mode GT conditioning)")
    p.add_argument("--prior_embeds_dir", type=str, default=None,
                   help="stage-1 .npy output dir (test mode)")
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
    p.add_argument("--encoder_cache_interval", type=int, default=1,
                   help=">1 = encoder-propagation sampling (the UNet's "
                        "encoder runs on every k-th step only; approximate). "
                        "1 (default) = reference-exact")
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--simple_variant", action="store_true",
                   help="released simplified checkpoint: no prior / class "
                        "embedding")
    p.add_argument("--tiny_config", action="store_true",
                   help="tiny-geometry models (CPU smoke runs)")
    p.add_argument("--train_ckpt_dir", type=str, default=None,
                   help="checkpoint dir of a port stage-2 training run "
                        "(cli/stage2_train.py --output_dir): its trained "
                        "unet, image_proj, pose_proj (EMA if tracked); pair "
                        "with --frozen_dir")
    p.add_argument("--frozen_dir", type=str, default=None,
                   help="frozen-encoder bundle (train/frozen.py) with vae "
                        "and dino, and clip for train-mode conditioning")
    p.add_argument("--device_select", action="store_true",
                   help="best-of-N SSIM selection on the device "
                        "(cli/common.device_select_best): only the chosen "
                        "candidate is read back; the same uint8 scoring as "
                        "the host path, which it can differ from only on "
                        "SSIM ties at the 1e-6 level (f32 vs f64)")
    p.add_argument("--sequential", action="store_true",
                   help="finish each batch (readback, selection, PNG "
                        "writes) before preparing the next, the reference's "
                        "ordering; the default overlaps them with the next "
                        "batch's sampling. Outputs are identical")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Exit where the JAX CLI cannot go on (``cli/common.py``)."""
    check_weight_flags(args, _PRETRAINED_FLAGS,
                       "the VAE / DINOv2 the run trained against")


def best_of_n_ssim(candidates: np.ndarray, gt: np.ndarray) -> int:
    """candidates: (N, H, W, 3) uint8 (the quantised readback) or float in
    [-1, 1]; gt: (H, W, 3) in [-1, 1]. The index of the best SSIM, first
    on ties (the reference's selection, which also scores uint8 pixels)."""
    from pcdms_tpu_torch.eval.metrics import compare_ssim
    gt01 = (gt + 1.0) / 2.0
    if candidates.dtype == np.uint8:
        cands01 = candidates.astype(np.float32) / 255.0
    else:
        cands01 = (candidates + 1.0) / 2.0
    scores = [compare_ssim(c, gt01, data_range=1.0, win_size=7)
              for c in cands01]
    return int(np.argmax(scores))


def build_models(args, train_mode: bool, device):
    """(configs, {unet, image_proj, pose_proj, vae} in bf16, dino, clip or
    None) on ``device``."""
    from pcdms_tpu_torch.models.projections import (
        ImageProjModel, PoseCondEmbedding,
    )
    from pcdms_tpu_torch.models.unet2d import (
        UNet2DConditionModel, stage2_unet_config,
    )
    from pcdms_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from pcdms_tpu_torch.models.vit import (
        VisionTransformer, clip_vit_h14_config, dinov2_giant_config,
    )

    with_class = not args.simple_variant
    if args.tiny_config:
        tiny = tiny_configs()
        unet_cfg, vae_cfg = tiny.unet2(with_class), tiny.vae
        dino_cfg, clip_cfg = tiny.dino, tiny.clip
        proj_kw, pose_kw = tiny.image_proj_kwargs, tiny.pose_proj_kwargs
    else:
        unet_cfg, vae_cfg = stage2_unet_config(with_class), VAEConfig()
        dino_cfg, clip_cfg = dinov2_giant_config(), clip_vit_h14_config()
        proj_kw, pose_kw = {}, {}

    trainable = {
        "unet": lambda: UNet2DConditionModel(unet_cfg),
        "image_proj": lambda: ImageProjModel(**proj_kw),
        "pose_proj": lambda: PoseCondEmbedding(**pose_kw),
    }
    frozen = {"vae": lambda: AutoencoderKL(vae_cfg),
              "dino": lambda: VisionTransformer(dino_cfg)}
    if train_mode:
        frozen["clip"] = lambda: VisionTransformer(clip_cfg)

    def pretrained():
        from pcdms_tpu_torch.compat.load import (
            load_clip_vision, load_pcdms_stage2_checkpoint,
        )
        if train_mode and not args.image_encoder_g_path:
            raise SystemExit("train mode needs --image_encoder_g_path "
                             "without --random_init or --train_ckpt_dir")
        weights = load_pcdms_stage2_checkpoint(args.weights_name)
        weights.update(pretrained_vae_dino(args, dino_cfg))
        if train_mode:
            weights["clip"] = load_clip_vision(args.image_encoder_g_path)
        return weights

    models = {k: m.to(torch.bfloat16) for k, m in build_cli_models(
        args, trainable, frozen, device, pretrained).items()}
    dino, clip = models.pop("dino"), models.pop("clip", None)
    return models, dino, clip


def main(argv=None):
    """Run the batch test; returns the paths of the PNGs written."""
    setup_logging()
    args = parse_args(argv)
    check_supported(args)
    mesh = make_mesh(args.device)
    device = mesh.device
    os.makedirs(args.save_path, exist_ok=True)

    from pcdms_tpu_torch.data.datasets import PairList
    from pcdms_tpu_torch.data.preprocess import (
        black_like, clip_preprocess, load_image, make_side_by_side, to_neg1_1,
    )
    from pcdms_tpu_torch.pipelines.stage2_inpaint import stage2_generate
    from pcdms_tpu_torch.train.encoders import (
        clip_image_embed, dino_features,
    )

    pairs = PairList(args.json_path, args.image_root_path).shard(
        *process_shard(mesh))
    train_mode = os.path.basename(args.json_path).startswith("train")
    if train_mode:
        logger.info("train-mode conditioning: GT CLIP embeddings")
    models, dino, clip = build_models(args, train_mode, device)
    size = (args.img_width, args.img_height)
    items, bs, written = pairs.pairs, args.batch_size, []
    t0 = time.time()

    def finish(pending):
        """Wait for one batch's readback, select, write its PNGs."""
        chunk, readback, t_imgs, start, n = pending
        images = wait_readback(*readback)
        w = args.img_width
        for i, item in enumerate(chunk):
            if args.device_select:
                best_img = images[i]
            else:
                cands = images[i::n][:, :, w:, :]       # right halves
                best_img = cands[best_of_n_ssim(cands, to_neg1_1(t_imgs[i]))]
            path = os.path.join(args.save_path, f"{pair_stem(item)}.png")
            save_images(best_img[None], [path])
            written.append(path)
        logger.info("processed %d/%d", min(start + bs, len(items)),
                    len(items))

    pending = None
    for start in range(0, len(items), bs):
        chunk = items[start:start + bs]
        s_imgs = [load_image(pairs.image_path(i["source_image"]), size)
                  for i in chunk]
        t_imgs = [load_image(pairs.image_path(i["target_image"]), size)
                  for i in chunk]
        s_poses = [load_image(pairs.pose_img_path(i["source_image"]), size)
                   for i in chunk]
        t_poses = [load_image(pairs.pose_img_path(i["target_image"]), size)
                   for i in chunk]
        canvas = np.stack([
            to_neg1_1(make_side_by_side(s, black_like(s))) for s in s_imgs])
        pose_canvas = np.stack([
            to_neg1_1(make_side_by_side(sp, tp))
            for sp, tp in zip(s_poses, t_poses)])
        s_pix = np.stack([clip_preprocess(s) for s in s_imgs])

        with torch.inference_mode():
            feats = dino_features(dino, s_pix)
            if args.simple_variant:
                embeds = None
            elif train_mode:
                t_pix = np.stack([clip_preprocess(t) for t in t_imgs])
                embeds = clip_image_embed(clip, t_pix)[:, None, :]
            elif args.prior_embeds_dir:
                embeds = []
                for item in chunk:
                    embeds.append(np.load(os.path.join(
                        args.prior_embeds_dir,
                        f"{pair_stem(item)}.npy")).reshape(1, -1))
                embeds = np.stack(embeds).astype(np.float32)
            else:
                raise SystemExit("need --prior_embeds_dir or "
                                 "--simple_variant (or a train-mode json)")

            n = len(chunk)
            # keyed by the pairs' global indices: a rank of a world of N
            # draws what one process draws for the same pairs
            index = global_indices(start, n, mesh)
            latents = per_item_latents(
                args.seed, index, args.num_images_per_prompt,
                (args.img_height // 8, args.img_width // 4, 4))
            images = stage2_generate(
                models, canvas, pose_canvas, feats, embeds,
                generator=torch.Generator(device=device).manual_seed(
                    args.seed + index[0]),
                latents=latents, num_steps=args.num_inference_steps,
                guidance_scale=args.guidance_scale,
                scheduler=args.scheduler,
                num_samples=args.num_images_per_prompt,
                encoder_cache_interval=args.encoder_cache_interval,
                device=device)
            if args.device_select:
                gt_u8 = np.stack([np.asarray(t, np.uint8) for t in t_imgs])
                dev_images, _ = device_select_best(
                    images, gt_u8, args.num_images_per_prompt)
            else:
                dev_images = device_uint8(images)
            readback = queue_readback(dev_images)
        if args.sequential:
            finish((chunk, readback, t_imgs, start, n))
            continue
        if pending is not None:
            finish(pending)
        pending = (chunk, readback, t_imgs, start, n)

    if pending is not None:
        finish(pending)
    logger.info("done in %.1fs", time.time() - t0)
    return written


if __name__ == "__main__":
    main()
