"""Stage-2 inpainting trainer CLI (counterpart of
``pcdms_tpu/cli/stage2_train.py``), flag-compatible with it. Runs on the
CUDA card unless ``--device cpu`` is given.

    python -m pcdms_tpu_torch.cli.stage2_train \\
        --pretrained_model_name_or_path /path/to/sd21 \\
        --image_encoder_p_path /path/to/dinov2-giant \\
        --image_encoder_g_path /path/to/clip-vit-h \\
        --json_path data.json --image_root_path /data --output_dir out \\
        --img_height 512 --img_width 512 --train_batch_size 8

Models: random from ``--seed`` (``--random_init``), or the UNet and VAE of
the SD-2.1 dir ``--pretrained_model_name_or_path`` and the DINOv2 / CLIP
dirs (``compat/load.py``): ``conv_in`` grows from 4 to 9 input channels
with zeros, and a UNet without a class embedding gets a seeded one, as the
JAX CLI does; the projections are drawn from ``--seed``. The JAX CLI draws
``--tiny_config`` models at random whatever the flags; the port loads the
dirs at any geometry. Batches come from the DeepFashion pair list
(``--json_path``, ``data/datasets.py::Stage2Dataset`` through
``data/loader.py``) with DINOv2-giant and CLIP ViT-H run on the fly, or read
from ``--cache_embeddings``; ``--synthetic_data`` trains on random batches.
Under ``torchrun --nproc_per_node N`` each rank trains on its own card
with ``--train_batch_size`` rows and the gradients are averaged over the
world (``parallel/mesh.py``); ``--zero1`` shards the AdamW moments over a
slice's ranks and ``--dcn_slices`` splits the world into slices.
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
from pcdms_tpu_torch.parallel.mesh import make_hybrid_mesh

logger = logging.getLogger("pcdms_tpu_torch.stage2_train")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_train_flags(p)
    p.add_argument("--image_encoder_p_path", type=str, default=None,
                   help="local DINOv2-giant dir")
    p.add_argument("--image_encoder_g_path", type=str, default=None,
                   help="local CLIP ViT-H dir")
    p.add_argument("--imgp_drop_rate", type=float, default=0.1)
    p.add_argument("--imgg_drop_rate", type=float, default=0.1)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--tiny_config", action="store_true",
                   help="tiny model geometry (CPU smoke of the full CLI "
                        "code path)")
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Exit when the data path has no pair list or pretrained loading lacks
    its files (``cli/common.py::check_train_flags``)."""
    flags = ["pretrained_model_name_or_path"]
    if not args.synthetic_data:
        flags += ["image_encoder_p_path", "image_encoder_g_path"]
    check_train_flags(args, flags)


class ModelAux:
    """Sizes of the synthetic conditioning (full-size defaults)."""

    def __init__(self, dino_tokens=257, dino_dim=1536, clip_dim=1024):
        self.dino_tokens = dino_tokens
        self.dino_dim = dino_dim
        self.clip_dim = clip_dim


def build_models(args, device):
    """(unet_cfg, trainable {unet, image_proj, pose_proj}, frozen vae, clip,
    dino, aux) in f32 on ``device``: random weights from ``args.seed``, or
    loaded from the pretrained dirs without ``--random_init``. The CLIP and
    DINOv2 encoders are built only for the DeepFashion data path (None with
    ``--synthetic_data``); the frozen models go through ``--frozen_dir``."""
    import dataclasses

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
    from pcdms_tpu_torch.train.frozen import frozen_dir_or_build

    if args.tiny_config:
        tiny = tiny_configs()
        unet_cfg, vae_cfg = tiny.unet2(with_class_embed=True), tiny.vae
        clip_cfg, dino_cfg = tiny.clip, tiny.dino
        proj_kw, pose_kw = tiny.image_proj_kwargs, tiny.pose_proj_kwargs
        aux = ModelAux(tiny.dino_tokens, tiny.dino_dim, tiny.clip_dim)
    else:
        unet_cfg, vae_cfg = stage2_unet_config(), VAEConfig()
        clip_cfg, dino_cfg = clip_vit_h14_config(), dinov2_giant_config()
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

        makers = {"vae": lambda: AutoencoderKL(vae_cfg)}
        if not args.synthetic_data:
            makers.update(clip=lambda: VisionTransformer(clip_cfg),
                          dino=lambda: VisionTransformer(dino_cfg))
        frozen = frozen_dir_or_build(args.frozen_dir,
                                     frozen_loaders(args, makers))
    vae, clip, dino = (frozen.get(k) for k in ("vae", "clip", "dino"))
    clip, dino = (None if m is None else m.eval() for m in (clip, dino))
    return unet_cfg, trainable, vae.eval(), clip, dino, aux


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


def synthetic_batches(args, aux=None, mesh=None):
    """Random batches of the right shapes, from numpy seeded with
    ``args.seed`` (the same values as the JAX CLI's). Over a ``mesh`` the
    stream is the global batch of ``world * --train_batch_size`` rows and
    each rank yields its own rows."""
    from pcdms_tpu_torch.parallel.mesh import shard_batch
    aux = aux or ModelAux()
    rng = np.random.default_rng(args.seed)
    world = 1 if mesh is None else mesh.world
    b, h, w = (world * args.train_batch_size, args.img_height,
               2 * args.img_width)
    while True:
        yield shard_batch({
            "st_image": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
            "masked_image": rng.uniform(-1, 1, (b, h, w, 3)).astype(
                np.float32),
            "pose_image": rng.uniform(-1, 1, (b, h, w, 3)).astype(
                np.float32),
            "dino_features": rng.standard_normal(
                (b, aux.dino_tokens, aux.dino_dim), dtype=np.float32),
            "clip_embed": rng.standard_normal(
                (b, 1, aux.clip_dim), dtype=np.float32),
        }, mesh)


def make_batches(args, clip, dino, aux=None,
                 encoder_dtype: torch.dtype = torch.bfloat16, mesh=None):
    """The trainer's batches: ``synthetic_batches``, or the DeepFashion data
    path through the ``DataLoader`` with the DINOv2 features of the source
    and the CLIP embedding of the target computed on the fly in
    ``encoder_dtype``, or read from the ``--cache_embeddings`` caches
    (``s2_dino_{W}x{H}``, f16, and ``s2_clip_{W}x{H}``). With the cache the
    encoders are freed once it is built, before the first batch is
    yielded. Over a ``mesh`` each rank reads its share of the pair list."""
    if args.synthetic_data:
        yield from synthetic_batches(args, aux, mesh)
        return
    from pcdms_tpu_torch.data.datasets import PairList, Stage2Dataset
    from pcdms_tpu_torch.data.loader import DataLoader
    from pcdms_tpu_torch.train import encoders
    from pcdms_tpu_torch.utils.tree import cast_tree

    pairs = PairList(args.json_path, args.image_root_path).shard(
        *process_shard(mesh))
    use_cache = args.cache_embeddings is not None
    size = (args.img_width, args.img_height)
    dataset = Stage2Dataset(pairs, size=size,
                            imgp_drop_rate=args.imgp_drop_rate,
                            imgg_drop_rate=args.imgg_drop_rate,
                            seed=args.seed, embed_refs=use_cache)
    clip = cast_tree(clip, encoder_dtype)
    dino = cast_tree(dino, encoder_dtype)
    loader = DataLoader(dataset, args.train_batch_size,
                        num_workers=args.dataloader_num_workers,
                        seed=args.seed)

    def dino_fn(px):
        return encoders.dino_features(dino, px, encoder_dtype)

    def clip_fn(px):
        return encoders.clip_image_embed(clip, px, encoder_dtype)

    if use_cache:
        from pcdms_tpu_torch.data.preprocess import clip_preprocess, load_image
        from pcdms_tpu_torch.train.embed_cache import build_or_load

        def pre(p):
            return clip_preprocess(load_image(p, size))

        tag = f"{args.img_width}x{args.img_height}"
        # DINOv2 feature maps are (257, 1536) per image: stored in f16
        dino_cache = build_or_load(
            args.cache_embeddings, f"s2_dino_{tag}", dino_fn, pre,
            [pairs.image_path(i["source_image"]) for i in pairs.pairs],
            batch_size=args.train_batch_size, store_dtype=np.float16)
        clip_cache = build_or_load(
            args.cache_embeddings, f"s2_clip_{tag}", clip_fn, pre,
            [pairs.image_path(i["target_image"]) for i in pairs.pairs],
            batch_size=args.train_batch_size)
        # the encoders (CLIP-H and DINOv2-g) are needed only to build the
        # caches: free them before the train step allocates its state
        del clip, dino, dino_fn, clip_fn
        torch.cuda.empty_cache()
        for batch in loader:
            yield {
                "st_image": batch["st_image"],
                "masked_image": batch["masked_image"],
                "pose_image": batch["pose_image"],
                "dino_features": dino_cache.lookup(batch["s_ref"],
                                                   batch["s_drop"]),
                "clip_embed": clip_cache.lookup(batch["t_ref"],
                                                batch["t_drop"])[:, None, :],
            }
        return

    for batch in loader:
        yield {
            "st_image": batch["st_image"],
            "masked_image": batch["masked_image"],
            "pose_image": batch["pose_image"],
            "dino_features": dino_fn(batch["clip_s_img"]),
            "clip_embed": clip_fn(batch["clip_t_img"])[:, None, :],
        }


def main(argv=None):
    """Train; returns the final ``TrainState``."""
    setup_logging()
    args = parse_args(argv)
    check_supported(args)
    mesh = make_hybrid_mesh(args.dcn_slices, args.device)
    device = mesh.device
    tcfg = train_config_from_args(args)
    dtype = compute_dtype_from_args(args)

    _, trainable, vae, clip, dino, aux = build_models(args, device)

    from pcdms_tpu_torch.train.loop import run_training
    from pcdms_tpu_torch.train.stage2 import stage2_loss_fn

    loss_fn = stage2_loss_fn(vae, noise_offset=args.noise_offset,
                             compute_dtype=dtype, mesh=mesh)
    batches = make_batches(args, clip, dino, aux, mesh=mesh)
    # the generator owns the encoders now and frees them after a cache
    # build; a reference kept here would pin them on the device
    del clip, dino, vae
    return run_training(loss_fn, trainable, batches, tcfg, mesh=mesh,
                        seed=args.seed, output_dir=args.output_dir,
                        checkpointing_steps=args.checkpointing_steps,
                        log_every=args.log_every,
                        resume_from_checkpoint=args.resume_from_checkpoint,
                        profile_dir=args.profile_dir,
                        tensorboard_writer=tensorboard_writer_from_args(args))


if __name__ == "__main__":
    main()
