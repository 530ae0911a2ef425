"""Stage-3 refinement trainer CLI (counterpart of
``pcdms_tpu/cli/stage3_train.py``), flag-compatible with it: trains the
8-channel img2img UNet that polishes stage-2 outputs. Runs on the CUDA card
unless ``--device cpu`` is given.

    python -m pcdms_tpu_torch.cli.stage3_train \\
        --pretrained_model_name_or_path /path/to/sd21 \\
        --image_encoder_p_path /path/to/dinov2-giant \\
        --json_path data.json --image_root_path /data --gen_dir stage2_out \\
        --output_dir out

Models: random from ``--seed`` (``--random_init``), or the UNet and VAE of
the SD-2.1 dir ``--pretrained_model_name_or_path`` (``conv_in`` grown from
4 to 8 input channels with zeros) and DINOv2 from ``--image_encoder_p_path``
(``compat/load.py``); the image projection is drawn from ``--seed``. The
stage-2 images are read from ``--gen_dir`` as ``{src}_to_{tgt}.png``.
Batches come from ``data/datasets.py::Stage3Dataset`` through
``data/loader.py`` with DINOv2 run on the fly, or read from
``--cache_embeddings`` (``s3_dino_{W}x{H}``, f16); ``--synthetic_data``
trains on random batches.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from pcdms_tpu_torch.cli.common import (
    add_common_train_flags, check_train_flags, compute_dtype_from_args,
    frozen_loaders, process_shard, setup_logging,
    tensorboard_writer_from_args, tiny_configs, train_config_from_args,
)
from pcdms_tpu_torch.cli.stage2_train import ModelAux, _grow_conv_in
from pcdms_tpu_torch.parallel.mesh import make_hybrid_mesh

logger = logging.getLogger("pcdms_tpu_torch.stage3_train")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_train_flags(p)
    p.add_argument("--image_encoder_p_path", type=str, default=None,
                   help="local DINOv2-giant dir")
    p.add_argument("--gen_dir", type=str, default=None,
                   help="directory of stage-2 generated images")
    p.add_argument("--gen_drop_rate", type=float, default=0.1)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--tiny_config", action="store_true",
                   help="tiny model geometry (CPU smoke of the full CLI "
                        "code path)")
    p.set_defaults(learning_rate=1e-5, train_batch_size=16)
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Exit when the data path lacks its pair list or ``--gen_dir``, or
    pretrained loading its files."""
    flags = ["pretrained_model_name_or_path"]
    if not args.synthetic_data:
        flags.append("image_encoder_p_path")
    check_train_flags(args, flags)
    if not args.synthetic_data and not args.gen_dir:
        raise SystemExit("--gen_dir required without --synthetic_data")


def build_models(args, device):
    """(unet_cfg, trainable {unet, image_proj}, frozen vae, dino, aux) in f32
    on ``device``. DINOv2 is built only for the DeepFashion data path (None
    with ``--synthetic_data``); the frozen models go through
    ``--frozen_dir``."""
    import dataclasses

    from pcdms_tpu_torch.models.projections import ImageProjModel
    from pcdms_tpu_torch.models.unet2d import (
        UNet2DConditionModel, stage3_unet_config,
    )
    from pcdms_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from pcdms_tpu_torch.models.vit import (
        VisionTransformer, dinov2_giant_config,
    )
    from pcdms_tpu_torch.train.frozen import frozen_dir_or_build

    if args.tiny_config:
        tiny = tiny_configs()
        unet_cfg, vae_cfg, dino_cfg = tiny.unet3, tiny.vae, tiny.dino
        proj_kw = tiny.image_proj_kwargs
        aux = ModelAux(tiny.dino_tokens, tiny.dino_dim, tiny.clip_dim)
    else:
        unet_cfg, vae_cfg = stage3_unet_config(), VAEConfig()
        dino_cfg, proj_kw, aux = dinov2_giant_config(), {}, ModelAux()
    if args.gradient_checkpointing:
        unet_cfg = dataclasses.replace(unet_cfg, remat=True)

    torch.manual_seed(args.seed)
    with torch.device(device):
        trainable = {"unet": UNet2DConditionModel(unet_cfg),
                     "image_proj": ImageProjModel(**proj_kw)}
        if not args.random_init:
            from pcdms_tpu_torch.compat.load import load_into, load_sd_unet
            sd = _grow_conv_in(
                load_sd_unet(args.pretrained_model_name_or_path), unet_cfg)
            load_into(trainable["unet"], sd, "unet")
        makers = {"vae": lambda: AutoencoderKL(vae_cfg)}
        if not args.synthetic_data:
            makers["dino"] = lambda: VisionTransformer(dino_cfg)
        frozen = frozen_dir_or_build(args.frozen_dir,
                                     frozen_loaders(args, makers))
    dino = frozen.get("dino")
    return (unet_cfg, trainable, frozen["vae"].eval(),
            None if dino is None else dino.eval(), aux)


def synthetic_batches(args, aux=None, mesh=None):
    """Random batches of the right shapes, from numpy seeded with
    ``args.seed`` (the same values as the JAX CLI's). Over a ``mesh`` the
    stream is the global batch of ``world * --train_batch_size`` rows and
    each rank yields its own rows."""
    from pcdms_tpu_torch.parallel.mesh import shard_batch
    aux = aux or ModelAux()
    rng = np.random.default_rng(args.seed)
    world = 1 if mesh is None else mesh.world
    b, h, w = world * args.train_batch_size, args.img_height, args.img_width
    while True:
        yield shard_batch({
            "target_image": rng.uniform(-1, 1, (b, h, w, 3)).astype(
                np.float32),
            "gen_image": rng.uniform(-1, 1, (b, h, w, 3)).astype(
                np.float32),
            "dino_features": rng.standard_normal(
                (b, aux.dino_tokens, aux.dino_dim), dtype=np.float32),
        }, mesh)


def make_batches(args, dino, aux=None,
                 encoder_dtype: torch.dtype = torch.bfloat16, mesh=None):
    """The trainer's batches: ``synthetic_batches``, or the DeepFashion data
    path with the source's DINOv2 features computed on the fly in
    ``encoder_dtype`` or read from ``--cache_embeddings``. With the cache,
    DINOv2 is freed once it is built, before the first batch is yielded.
    Over a ``mesh`` each rank reads its share of the pair list."""
    if args.synthetic_data:
        yield from synthetic_batches(args, aux, mesh)
        return
    from pcdms_tpu_torch.data.datasets import PairList, Stage3Dataset
    from pcdms_tpu_torch.data.loader import DataLoader
    from pcdms_tpu_torch.train import encoders
    from pcdms_tpu_torch.utils.tree import cast_tree

    pairs = PairList(args.json_path, args.image_root_path).shard(
        *process_shard(mesh))
    use_cache = args.cache_embeddings is not None
    size = (args.img_width, args.img_height)
    dataset = Stage3Dataset(pairs, args.gen_dir, size=size,
                            gen_drop_rate=args.gen_drop_rate,
                            seed=args.seed, embed_refs=use_cache)
    dino = cast_tree(dino, encoder_dtype)
    loader = DataLoader(dataset, args.train_batch_size,
                        num_workers=args.dataloader_num_workers,
                        seed=args.seed)

    def dino_fn(px):
        return encoders.dino_features(dino, px, encoder_dtype)

    if use_cache:
        from pcdms_tpu_torch.data.preprocess import clip_preprocess, load_image
        from pcdms_tpu_torch.train.embed_cache import build_or_load
        cache = build_or_load(
            args.cache_embeddings,
            f"s3_dino_{args.img_width}x{args.img_height}", dino_fn,
            lambda p: clip_preprocess(load_image(p, size)),
            [pairs.image_path(i["source_image"]) for i in pairs.pairs],
            batch_size=args.train_batch_size, store_dtype=np.float16)
        del dino, dino_fn          # free DINOv2 before the train state
        torch.cuda.empty_cache()
        for batch in loader:
            yield {"target_image": batch["target_image"],
                   "gen_image": batch["gen_image"],
                   "dino_features": cache.lookup(batch["s_ref"])}
        return

    for batch in loader:
        yield {"target_image": batch["target_image"],
               "gen_image": batch["gen_image"],
               "dino_features": dino_fn(batch["clip_s_img"])}


def main(argv=None):
    """Train; returns the final ``TrainState``."""
    setup_logging()
    args = parse_args(argv)
    check_supported(args)
    mesh = make_hybrid_mesh(args.dcn_slices, args.device)
    device = mesh.device
    tcfg = train_config_from_args(args)
    dtype = compute_dtype_from_args(args)

    _, trainable, vae, dino, aux = build_models(args, device)

    from pcdms_tpu_torch.train.loop import run_training
    from pcdms_tpu_torch.train.stage3 import stage3_loss_fn

    loss_fn = stage3_loss_fn(vae, noise_offset=args.noise_offset,
                             compute_dtype=dtype, mesh=mesh)
    batches = make_batches(args, dino, aux, mesh=mesh)
    del dino, vae        # the generator owns DINOv2 now (see stage 2)
    return run_training(loss_fn, trainable, batches, tcfg, mesh=mesh,
                        seed=args.seed, output_dir=args.output_dir,
                        checkpointing_steps=args.checkpointing_steps,
                        log_every=args.log_every,
                        resume_from_checkpoint=args.resume_from_checkpoint,
                        profile_dir=args.profile_dir,
                        tensorboard_writer=tensorboard_writer_from_args(args))


if __name__ == "__main__":
    main()
