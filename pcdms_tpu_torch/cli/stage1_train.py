"""Stage-1 prior trainer CLI (counterpart of
``pcdms_tpu/cli/stage1_train.py``), flag-compatible with it: diffuses the
target's CLIP embedding from the source's and the two poses. Defaults follow
the reference's launcher (batch 128, lr 1e-5, 100k steps). Runs on the CUDA
card unless ``--device cpu`` is given.

    python -m pcdms_tpu_torch.cli.stage1_train \\
        --image_encoder_path /path/to/clip-vit-h --prior_path /path/to/prior \\
        --json_path data.json --image_root_path /data --output_dir out

Models: the prior random from ``--seed`` or loaded from ``--prior_path``
(``compat/load.py::load_prior``); CLIP ViT-H random or loaded from
``--image_encoder_path``, and built only for the DeepFashion data path, as
in the JAX CLI. Batches come from ``data/datasets.py::Stage1Dataset``
through ``data/loader.py`` with CLIP run on the fly, or read from
``--cache_embeddings`` (``s1_clip_{W}x{H}``); ``--synthetic_data`` trains on
random batches.
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

logger = logging.getLogger("pcdms_tpu_torch.stage1_train")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_train_flags(p)
    p.add_argument("--image_encoder_path", type=str, default=None,
                   help="local CLIP ViT-H dir")
    p.add_argument("--prior_path", type=str, default=None,
                   help="local Kandinsky-2-2 prior dir for weight init")
    p.add_argument("--s_img_drop_rate", type=float, default=0.1)
    p.add_argument("--s_pose_drop_rate", type=float, default=0.1)
    p.add_argument("--t_pose_drop_rate", type=float, default=0.1)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--tiny_config", action="store_true",
                   help="tiny model geometry (CPU smoke of the full CLI "
                        "code path)")
    p.set_defaults(learning_rate=1e-5, train_batch_size=128,
                   max_train_steps=100_000)
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Exit when the data path lacks its pair list or, without
    ``--random_init``, CLIP's dir."""
    check_train_flags(args, [] if args.synthetic_data
                      else ["image_encoder_path"])


def build_models(args, device):
    """(prior_cfg, trainable {prior}, clip or None) in f32 on ``device``.
    CLIP is built only for the DeepFashion data path, through
    ``--frozen_dir``."""
    from pcdms_tpu_torch.models.prior_transformer import (
        PriorConfig, PriorTransformer,
    )
    from pcdms_tpu_torch.models.vit import (
        VisionTransformer, clip_vit_h14_config,
    )
    from pcdms_tpu_torch.train.frozen import frozen_dir_or_build

    if args.tiny_config:
        tiny = tiny_configs()
        prior_cfg, clip_cfg = tiny.prior, tiny.clip
    else:
        prior_cfg, clip_cfg = PriorConfig(), clip_vit_h14_config()

    torch.manual_seed(args.seed)
    with torch.device(device):
        prior = PriorTransformer(prior_cfg)
        if not args.random_init and args.prior_path:
            from pcdms_tpu_torch.compat.load import load_into, load_prior
            load_into(prior, load_prior(args.prior_path), "prior")
        clip = None
        if not args.synthetic_data:
            clip = frozen_dir_or_build(args.frozen_dir, frozen_loaders(
                args, {"clip": lambda: VisionTransformer(clip_cfg)})
            )["clip"].eval()
    return prior_cfg, {"prior": prior}, clip


def synthetic_batches(args, embed_dim=1024, mesh=None):
    """Random batches of the right shapes, from numpy seeded with
    ``args.seed`` (the same values as the JAX CLI's). Over a ``mesh`` the
    stream is the global batch of ``world * --train_batch_size`` rows and
    each rank yields its own rows."""
    from pcdms_tpu_torch.parallel.mesh import shard_batch
    rng = np.random.default_rng(args.seed)
    b = (1 if mesh is None else mesh.world) * args.train_batch_size
    while True:
        yield shard_batch({
            "s_embed": rng.standard_normal((b, embed_dim), dtype=np.float32),
            "t_embed": rng.standard_normal((b, embed_dim), dtype=np.float32),
            "s_pose": rng.random((b, 36), dtype=np.float32),
            "t_pose": rng.random((b, 36), dtype=np.float32),
        }, mesh)


def make_batches(args, clip, embed_dim=1024,
                 encoder_dtype: torch.dtype = torch.bfloat16, mesh=None):
    """The trainer's batches: ``synthetic_batches``, or the DeepFashion data
    path with both images' CLIP embeddings computed on the fly in
    ``encoder_dtype`` or read from ``--cache_embeddings``. With the cache,
    CLIP is freed once it is built, before the first batch is yielded.
    Over a ``mesh`` each rank reads its share of the pair list."""
    if args.synthetic_data:
        yield from synthetic_batches(args, embed_dim, mesh)
        return
    from pcdms_tpu_torch.data.datasets import PairList, Stage1Dataset
    from pcdms_tpu_torch.data.loader import DataLoader
    from pcdms_tpu_torch.data.preprocess import clip_preprocess, load_image
    from pcdms_tpu_torch.train import encoders
    from pcdms_tpu_torch.utils.tree import cast_tree

    pairs = PairList(args.json_path, args.image_root_path).shard(
        *process_shard(mesh))
    size = (args.img_width, args.img_height)
    use_cache = args.cache_embeddings is not None
    dataset = Stage1Dataset(pairs, size=size,
                            s_img_drop_rate=args.s_img_drop_rate,
                            s_pose_drop_rate=args.s_pose_drop_rate,
                            t_pose_drop_rate=args.t_pose_drop_rate,
                            seed=args.seed, embed_refs=use_cache)
    clip = cast_tree(clip, encoder_dtype)
    loader = DataLoader(dataset, args.train_batch_size,
                        num_workers=args.dataloader_num_workers,
                        seed=args.seed)

    def encode(px):
        return encoders.clip_image_embed(clip, px, encoder_dtype)

    if use_cache:
        from pcdms_tpu_torch.train.embed_cache import build_or_load
        paths = [pairs.image_path(i[k]) for i in pairs.pairs
                 for k in ("source_image", "target_image")]
        cache = build_or_load(
            args.cache_embeddings,
            f"s1_clip_{args.img_width}x{args.img_height}", encode,
            lambda p: clip_preprocess(load_image(p, size)), paths,
            batch_size=args.train_batch_size)
        del clip, encode           # free CLIP before the train state
        torch.cuda.empty_cache()
        for batch in loader:
            yield {
                "s_embed": cache.lookup(batch["s_ref"], batch["s_drop"]),
                "t_embed": cache.lookup(batch["t_ref"], batch["t_drop"]),
                "s_pose": batch["s_pose"],
                "t_pose": batch["t_pose"],
            }
        return

    for batch in loader:
        yield {
            "s_embed": encode(batch["clip_s_img"]),
            "t_embed": encode(batch["clip_t_img"]),
            "s_pose": batch["s_pose"],
            "t_pose": batch["t_pose"],
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

    prior_cfg, trainable, clip = build_models(args, device)

    from pcdms_tpu_torch.train.loop import run_training
    from pcdms_tpu_torch.train.stage1 import stage1_loss_fn

    loss_fn = stage1_loss_fn(noise_offset=args.noise_offset,
                             compute_dtype=dtype, mesh=mesh)
    batches = make_batches(args, clip, embed_dim=prior_cfg.embedding_dim,
                           mesh=mesh)
    del clip             # the generator owns CLIP now (see stage 2)
    return run_training(loss_fn, trainable, batches, tcfg, mesh=mesh,
                        seed=args.seed, output_dir=args.output_dir,
                        checkpointing_steps=args.checkpointing_steps,
                        log_every=args.log_every,
                        resume_from_checkpoint=args.resume_from_checkpoint,
                        profile_dir=args.profile_dir,
                        tensorboard_writer=tensorboard_writer_from_args(args))


if __name__ == "__main__":
    main()
