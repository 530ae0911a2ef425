"""Stage-2 inpainting trainer CLI (counterpart of
``pcdms_tpu/cli/stage2_train.py``), flag-compatible with it. Runs on the
CUDA card unless ``--device cpu`` is given.

    python -m pcdms_tpu_torch.cli.stage2_train --random_init \\
        --synthetic_data --output_dir out --img_height 512 --img_width 512 \\
        --train_batch_size 2 --max_train_steps 100

What this slice ports: random-init models (``--random_init``, full width or
``--tiny_config``) trained on synthetic batches. Flags that need unported
parts raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from pcdms_tpu_torch.cli.common import (
    add_common_train_flags, compute_dtype_from_args, setup_logging,
    tiny_configs, train_config_from_args,
)
from pcdms_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("pcdms_tpu_torch.stage2_train")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_train_flags(p)
    p.add_argument("--image_encoder_p_path", type=str, default=None,
                   help="local DINOv2-giant dir (used with the DeepFashion "
                        "data path, not ported yet)")
    p.add_argument("--image_encoder_g_path", type=str, default=None,
                   help="local CLIP ViT-H dir (used with the DeepFashion "
                        "data path, not ported yet)")
    p.add_argument("--imgp_drop_rate", type=float, default=0.1)
    p.add_argument("--imgg_drop_rate", type=float, default=0.1)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--tiny_config", action="store_true",
                   help="tiny model geometry (CPU smoke of the full CLI "
                        "code path)")
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Raise for flags whose code is not ported yet (ROADMAP.md section 1)."""
    if not args.random_init:
        raise NotImplementedError(
            "loading pretrained SD-2.1 weights is not ported yet (ROADMAP "
            "item 18): pass --random_init")
    if not args.synthetic_data:
        raise NotImplementedError(
            "the DeepFashion data path of the trainer is not ported yet "
            "(ROADMAP item 19b; the DINOv2 / CLIP encoders it feeds are, in "
            "train/encoders.py): pass --synthetic_data")
    if args.zero1 or args.dcn_slices > 1:
        raise NotImplementedError(
            "--zero1 and --dcn_slices > 1 need the DDP / ZeRO-1 port "
            "(ROADMAP item 19b)")
    if args.report_to is not None:
        raise NotImplementedError("--report_to is not ported yet: metrics "
                                  "log to stdout")


class ModelAux:
    """Sizes of the synthetic conditioning (full-size defaults)."""

    def __init__(self, dino_tokens=257, dino_dim=1536, clip_dim=1024):
        self.dino_tokens = dino_tokens
        self.dino_dim = dino_dim
        self.clip_dim = clip_dim


def build_models(args, device):
    """(unet_cfg, trainable {unet, image_proj, pose_proj}, frozen vae, aux),
    random weights from ``args.seed``, f32 on ``device``."""
    import dataclasses

    from pcdms_tpu_torch.models.projections import (
        ImageProjModel, PoseCondEmbedding,
    )
    from pcdms_tpu_torch.models.unet2d import (
        UNet2DConditionModel, stage2_unet_config,
    )
    from pcdms_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from pcdms_tpu_torch.train.frozen import frozen_dir_or_build

    if args.tiny_config:
        tiny = tiny_configs()
        unet_cfg, vae_cfg = tiny.unet2(with_class_embed=True), tiny.vae
        proj_kw, pose_kw = tiny.image_proj_kwargs, tiny.pose_proj_kwargs
        aux = ModelAux(tiny.dino_tokens, tiny.dino_dim, tiny.clip_dim)
    else:
        unet_cfg, vae_cfg = stage2_unet_config(), VAEConfig()
        proj_kw, pose_kw, aux = {}, {}, ModelAux()
    if args.gradient_checkpointing:
        unet_cfg = dataclasses.replace(unet_cfg, remat=True)

    torch.manual_seed(args.seed)
    with torch.device(device):
        trainable = {
            "unet": UNet2DConditionModel(unet_cfg),
            "image_proj": ImageProjModel(**proj_kw),
            "pose_proj": PoseCondEmbedding(**pose_kw),
        }
        vae = frozen_dir_or_build(
            args.frozen_dir, {"vae": lambda: AutoencoderKL(vae_cfg)})["vae"]
    return unet_cfg, trainable, vae.eval(), aux


def synthetic_batches(args, aux=None):
    """Random batches of the right shapes, from numpy seeded with
    ``args.seed`` (the same values as the JAX CLI's)."""
    aux = aux or ModelAux()
    rng = np.random.default_rng(args.seed)
    b, h, w = args.train_batch_size, args.img_height, 2 * args.img_width
    while True:
        yield {
            "st_image": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
            "masked_image": rng.uniform(-1, 1, (b, h, w, 3)).astype(
                np.float32),
            "pose_image": rng.uniform(-1, 1, (b, h, w, 3)).astype(
                np.float32),
            "dino_features": rng.standard_normal(
                (b, aux.dino_tokens, aux.dino_dim), dtype=np.float32),
            "clip_embed": rng.standard_normal(
                (b, 1, aux.clip_dim), dtype=np.float32),
        }


def main(argv=None):
    """Train; returns the final ``TrainState``."""
    setup_logging()
    args = parse_args(argv)
    check_supported(args)
    device = resolve_device(args.device)
    tcfg = train_config_from_args(args)
    dtype = compute_dtype_from_args(args)

    _, trainable, vae, aux = build_models(args, device)

    from pcdms_tpu_torch.train.loop import run_training
    from pcdms_tpu_torch.train.stage2 import stage2_loss_fn

    loss_fn = stage2_loss_fn(vae, noise_offset=args.noise_offset,
                             compute_dtype=dtype)
    return run_training(loss_fn, trainable, synthetic_batches(args, aux),
                        tcfg, device=device, seed=args.seed,
                        output_dir=args.output_dir,
                        checkpointing_steps=args.checkpointing_steps,
                        log_every=args.log_every,
                        resume_from_checkpoint=args.resume_from_checkpoint,
                        profile_dir=args.profile_dir)


if __name__ == "__main__":
    main()
