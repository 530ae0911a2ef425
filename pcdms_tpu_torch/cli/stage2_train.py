"""Stage-2 inpainting trainer CLI (counterpart of
``pcdms_tpu/cli/stage2_train.py``), flag-compatible with it. Runs on the
CUDA card unless ``--device cpu`` is given.

    python -m pcdms_tpu_torch.cli.stage2_train --random_init \\
        --synthetic_data --output_dir out --img_height 512 --img_width 512 \\
        --train_batch_size 2 --max_train_steps 100

Models: random from ``--seed`` (``--random_init``), or the UNet and VAE of
the SD-2.1 dir ``--pretrained_model_name_or_path`` (``compat/load.py``):
``conv_in`` grows from 4 to 9 input channels with zeros, and a UNet without
a class embedding gets a seeded one, as the JAX CLI does; the projections
are drawn from ``--seed``. The JAX CLI draws ``--tiny_config`` models at
random whatever the flags; the port loads the dir at any geometry. Batches
are synthetic. Flags that need unported parts raise
``NotImplementedError`` naming their ROADMAP item.
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
                   help="local DINOv2-giant dir (read by the DeepFashion "
                        "data path, not ported yet)")
    p.add_argument("--image_encoder_g_path", type=str, default=None,
                   help="local CLIP ViT-H dir (read by the DeepFashion "
                        "data path, not ported yet)")
    p.add_argument("--imgp_drop_rate", type=float, default=0.1)
    p.add_argument("--imgg_drop_rate", type=float, default=0.1)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--tiny_config", action="store_true",
                   help="tiny model geometry (CPU smoke of the full CLI "
                        "code path)")
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Raise for flags whose code is not ported yet (ROADMAP.md section 1);
    exit when pretrained loading has no SD-2.1 dir."""
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
    if not args.random_init and not args.pretrained_model_name_or_path:
        raise SystemExit("--pretrained_model_name_or_path required without "
                         "--random_init")


class ModelAux:
    """Sizes of the synthetic conditioning (full-size defaults)."""

    def __init__(self, dino_tokens=257, dino_dim=1536, clip_dim=1024):
        self.dino_tokens = dino_tokens
        self.dino_dim = dino_dim
        self.clip_dim = clip_dim


def build_models(args, device):
    """(unet_cfg, trainable {unet, image_proj, pose_proj}, frozen vae, aux)
    in f32 on ``device``: random weights from ``args.seed``, the UNet and VAE
    loaded from ``args.pretrained_model_name_or_path`` without
    ``--random_init``."""
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
        root = None if args.random_init else args.pretrained_model_name_or_path
        if root:
            from pcdms_tpu_torch.compat.load import load_into, load_sd_unet
            sd = _grow_conv_in(load_sd_unet(root), unet_cfg)
            sd = _maybe_init_class_embedding(sd, unet_cfg, args.seed)
            load_into(trainable["unet"], sd, "unet")

        def build_vae():
            vae = AutoencoderKL(vae_cfg)
            if root:
                from pcdms_tpu_torch.compat.load import load_into, load_sd_vae
                load_into(vae, load_sd_vae(root), "vae")
            return vae

        vae = frozen_dir_or_build(args.frozen_dir, {"vae": build_vae})["vae"]
    return unet_cfg, trainable, vae.eval(), aux


def _grow_conv_in(sd, cfg):
    """SD-2.1's 4-channel ``conv_in`` grown to ``cfg.in_channels`` with
    zero weights for the extra inputs (the reference's
    ``ignore_mismatched_sizes``); the file's channels are kept as they are."""
    w = sd["conv_in.weight"]
    if w.shape[1] < cfg.in_channels:
        extra = torch.zeros((w.shape[0], cfg.in_channels - w.shape[1])
                            + tuple(w.shape[2:]), dtype=w.dtype)
        sd["conv_in.weight"] = torch.cat([w, extra], dim=1)
    return sd


def _maybe_init_class_embedding(sd, cfg, seed):
    """A class embedding drawn from ``seed`` when the config has one and the
    file does not (SD-2.1 has none; the stage-2 UNet projects the target
    CLIP embedding through it)."""
    if cfg.class_embed_proj_dim and "class_embedding.linear_1.weight" not in sd:
        from pcdms_tpu_torch.nn.layers import TimestepEmbedding
        with torch.device("cpu"), torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            emb = TimestepEmbedding(cfg.class_embed_proj_dim,
                                    cfg.time_embed_dim)
        sd.update({f"class_embedding.{k}": v
                   for k, v in emb.state_dict().items()})
    return sd


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
