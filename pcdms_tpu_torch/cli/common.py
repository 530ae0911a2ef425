"""Shared CLI plumbing (counterpart of ``pcdms_tpu/cli/common.py``): the
reference's trainer flags, the ``TrainConfig`` they make, the trainers'
exits, the data-parallel mesh, the compute dtype, the port's own copy of the
tiny geometry (``--tiny_config``), and the batch test's latents, PNG
writing and on-device best-of-N selection."""

from __future__ import annotations

import argparse
import logging
from types import SimpleNamespace

import numpy as np
import torch


def setup_logging():
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S", level=logging.INFO)


def add_common_train_flags(p: argparse.ArgumentParser):
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None,
                   help="local SD-2.1 model dir (its unet/ and vae/)")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--img_height", type=int, default=512)
    p.add_argument("--img_width", type=int, default=512)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--train_batch_size", type=int, default=8)
    p.add_argument("--max_train_steps", type=int, default=1_000_000)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--checkpointing_steps", type=int, default=5000)
    p.add_argument("--noise_offset", type=float, default=0.1)
    p.add_argument("--lr_warmup_steps", type=int, default=5000)
    p.add_argument("--lr_scheduler", type=str,
                   default="constant_with_warmup")
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--mixed_precision", type=str, default="bf16",
                   choices=["no", "fp16", "bf16"],
                   help="fp16 is accepted for flag parity; bf16 is used")
    p.add_argument("--resume_from_checkpoint", action="store_true")
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="rematerialise UNet blocks in the backward pass")
    p.add_argument("--json_path", type=str, default=None)
    p.add_argument("--synthetic_data", action="store_true",
                   help="train on random tensors of the right shapes "
                        "(smoke tests and throughput runs without a "
                        "DeepFashion checkout)")
    p.add_argument("--image_root_path", type=str, default="")
    p.add_argument("--report_to", type=str, default=None,
                   help="'tensorboard': also write train_loss and "
                        "examples_per_sec to <output_dir>/logs; any other "
                        "value logs to stdout only")
    p.add_argument("--zero1", action="store_true",
                   help="shard the AdamW moments over the ranks of a slice "
                        "(ZeRO-1; several ranks under torchrun)")
    p.add_argument("--use_ema", action="store_true",
                   help="track an EMA of the trainable params, "
                        "checkpointed and exported by load_trained_params")
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--dcn_slices", type=int, default=1,
                   help="slices of consecutive ranks: ZeRO-1 shards stay "
                        "inside a slice, the gradient all-reduce spans the "
                        "world (the world must divide into them)")
    p.add_argument("--random_init", action="store_true",
                   help="random-init all models (no local checkpoints)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of steps 3-6 here")
    p.add_argument("--dataloader_num_workers", type=int, default=-1,
                   help="host input-pipeline worker threads; 0 = fetch "
                        "inline, -1 (default) = auto (min(8, cpu_count); 0 "
                        "on one core). The batch stream is the same for "
                        "any value")
    p.add_argument("--frozen_dir", type=str, default=None,
                   help="frozen-encoder bundle dir (train/frozen.py): load "
                        "the VAE / CLIP / DINOv2 from it if it exists, else "
                        "save the built ones there")
    p.add_argument("--cache_embeddings", type=str, default=None,
                   help="dir of the frozen-encoder embedding cache "
                        "(train/embed_cache.py): encode each image once, "
                        "with the zero-image dropout row, and train from "
                        "the cache")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card; the rank's "
                        "own card under torchrun) or 'cpu' (gloo)")


def train_config_from_args(args):
    from pcdms_tpu_torch.train.common import TrainConfig
    return TrainConfig(
        learning_rate=args.learning_rate,
        adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2,
        adam_weight_decay=args.adam_weight_decay,
        adam_epsilon=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm,
        lr_warmup_steps=args.lr_warmup_steps,
        max_train_steps=args.max_train_steps,
        lr_scheduler=args.lr_scheduler,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        noise_offset=args.noise_offset,
        zero1=args.zero1,
        use_ema=args.use_ema,
        ema_decay=args.ema_decay,
    )


def check_train_flags(args, pretrained_flags=()) -> None:
    """The trainers' exits: the DeepFashion data path without
    ``--json_path``, and pretrained loading without the files it reads,
    ``pretrained_flags``."""
    if not args.synthetic_data and not args.json_path:
        raise SystemExit("--json_path required without --synthetic_data")
    if args.random_init:
        return
    missing = [f"--{f}" for f in pretrained_flags if not getattr(args, f)]
    if missing:
        raise SystemExit(f"{', '.join(missing)} required without "
                         f"--random_init")


def frozen_loaders(args, makers):
    """{name: function} for ``train/frozen.py::frozen_dir_or_build``: each
    makes its module with ``makers[name]`` and, unless
    ``--random_init``, loads its pretrained file (``compat/load.py``):
    ``vae`` from the SD-2.1 dir, ``clip`` from ``--image_encoder_g_path``
    (stage 2) or ``--image_encoder_path`` (stage 1), ``dino`` from
    ``--image_encoder_p_path`` with its position embeddings resized to the
    module's grid."""
    def build(name, make):
        module = make()
        if args.random_init:
            return module
        from pcdms_tpu_torch.compat import load
        if name == "vae":
            sd = load.load_sd_vae(args.pretrained_model_name_or_path)
        elif name == "clip":
            sd = load.load_clip_vision(
                getattr(args, "image_encoder_g_path", None)
                or args.image_encoder_path)
        else:
            grid = module.cfg.image_size // module.cfg.patch_size
            sd = load.load_dinov2(args.image_encoder_p_path,
                                  target_grid=(grid, grid))
        return load.load_into(module, sd, name)

    return {name: (lambda n=name, m=make: build(n, m))
            for name, make in makers.items()}


def process_shard(mesh=None):
    """(rank, world size) of this process: its share of the pair list."""
    return (0, 1) if mesh is None else (mesh.rank, mesh.world)


def global_indices(start: int, n: int, mesh=None) -> list:
    """The pair-list indices of items ``start .. start + n`` of this rank's
    share (``PairList.shard(rank, world)`` takes every world-th pair)."""
    rank, world = process_shard(mesh)
    return [rank + world * (start + j) for j in range(n)]


def tensorboard_writer_from_args(args):
    """``--report_to tensorboard``: a writer on ``<output_dir>/logs``."""
    if args.report_to != "tensorboard":
        return None
    from pcdms_tpu_torch.train.loop import make_tensorboard_writer
    return make_tensorboard_writer(args.output_dir + "/logs")


def compute_dtype_from_args(args) -> torch.dtype:
    return torch.float32 if args.mixed_precision == "no" else torch.bfloat16


def tiny_configs() -> SimpleNamespace:
    """Tiny geometry for ``--tiny_config`` (the JAX package's
    ``tiny_configs``): CPU smoke runs of the full CLI paths without
    SD-2.1-scale models."""
    from pcdms_tpu_torch.models.prior_transformer import PriorConfig
    from pcdms_tpu_torch.models.unet2d import UNetConfig
    from pcdms_tpu_torch.models.vae import VAEConfig
    from pcdms_tpu_torch.models.vit import ViTConfig

    def unet2(with_class_embed=True):
        return UNetConfig(
            in_channels=9, block_out_channels=(8, 16, 16, 16),
            layers_per_block=1, cross_attention_dim=16, head_dim=8,
            class_embed_proj_dim=16 if with_class_embed else None,
            norm_groups=4, use_flash=False)

    return SimpleNamespace(
        prior=PriorConfig(num_heads=2, head_dim=8, num_layers=2,
                          embedding_dim=16, pose_hidden=8),
        clip=ViTConfig(hidden_size=24, num_layers=2, num_heads=2,
                       patch_size=32, projection_dim=16, pre_layernorm=True,
                       patch_bias=False, use_flash=False),
        dino=ViTConfig(hidden_size=24, num_layers=2, num_heads=2,
                       patch_size=32, layer_norm_eps=1e-6,
                       pre_layernorm=False, use_layer_scale=True,
                       use_swiglu=True, patch_bias=True, use_flash=False),
        unet2=unet2,
        unet3=UNetConfig(in_channels=8, block_out_channels=(8, 16, 16, 16),
                         layers_per_block=1, cross_attention_dim=16,
                         head_dim=8, norm_groups=4, use_flash=False),
        vae=VAEConfig(block_out_channels=(4, 8, 8, 8), layers_per_block=1,
                      norm_groups=2),
        image_proj_kwargs=dict(in_dim=24, hidden_dim=16, out_dim=16),
        pose_proj_kwargs=dict(out_channels=8,
                              block_out_channels=(4, 4, 4, 4)),
        dino_tokens=5, dino_dim=24, clip_dim=16,
    )


def check_weight_flags(args, pretrained_flags, frozen_what: str) -> None:
    """Exit where the JAX package's CLI cannot go on: ``--train_ckpt_dir``
    without its ``--frozen_dir``, and pretrained loading (neither
    ``--random_init`` nor ``--train_ckpt_dir``) without the files it reads,
    ``pretrained_flags``."""
    if args.train_ckpt_dir and not args.frozen_dir:
        raise SystemExit(f"--train_ckpt_dir needs --frozen_dir ({frozen_what}"
                         f")")
    if args.random_init or args.train_ckpt_dir:
        return
    missing = [f"--{f}" for f in pretrained_flags if not getattr(args, f)]
    if missing:
        raise SystemExit(f"{', '.join(missing)} required without "
                         f"--random_init or --train_ckpt_dir")


def build_cli_models(args, trainable, frozen, device, pretrained=None):
    """{name: module} on ``device``: ``trainable`` from the checkpoint in
    ``args.train_ckpt_dir`` (the EMA shadow if the run kept one) and
    ``frozen`` from the bundle in ``args.frozen_dir``; or all of them drawn
    from ``args.seed`` in that order (``--random_init``); or else all of
    them loaded from the pretrained files, ``pretrained()`` returning
    {name: state dict} (``compat/load.py``). ``trainable`` and ``frozen``
    map a name to a function that makes the module."""
    from pcdms_tpu_torch.train.frozen import (
        load_frozen_modules, load_trained_params,
    )
    builders = {**trainable, **frozen}
    with torch.device(device):
        if args.train_ckpt_dir:
            trained = load_trained_params(args.train_ckpt_dir)
            models = {}
            for name, build in trainable.items():
                models[name] = build()
                models[name].load_state_dict(trained[name])
            models.update(load_frozen_modules(args.frozen_dir, frozen))
        elif args.random_init:
            torch.manual_seed(args.seed)
            models = {name: build() for name, build in builders.items()}
        else:
            from pcdms_tpu_torch.compat.load import load_into
            weights = pretrained()
            models = {name: load_into(build(), weights.pop(name), name)
                      for name, build in builders.items()}
    return {k: m.eval() for k, m in models.items()}


def pretrained_vae_dino(args, dino_cfg) -> dict:
    """{"vae", "dino"} state dicts from ``--pretrained_model_name_or_path``
    and ``--image_encoder_p_path`` (``compat/load.py``). DINOv2's position
    embeddings are resized to ``dino_cfg``'s grid: (16, 16) at full width,
    as the JAX loader does; the tiny DINOv2's (7, 7), where the JAX CLI
    resizes its (16, 16) once more at run time."""
    from pcdms_tpu_torch.compat.load import load_dinov2, load_sd_vae
    grid = dino_cfg.image_size // dino_cfg.patch_size
    return {"vae": load_sd_vae(args.pretrained_model_name_or_path),
            "dino": load_dinov2(args.image_encoder_p_path,
                                target_grid=(grid, grid))}


def per_item_latents(seed, global_indices, num_samples, shape):
    """Initial latents keyed per (dataset item, sample index), sample-major:
    ``lat[s * n + j]`` is sample ``s`` of item ``global_indices[j]``, drawn
    by numpy exactly as the JAX package draws them, so outputs do not depend
    on the batch size and the two packages start from the same noise."""
    n = len(global_indices)
    lat = np.empty((num_samples * n,) + tuple(shape), np.float32)
    for s in range(num_samples):
        for j, g in enumerate(global_indices):
            rng = np.random.default_rng([int(seed), int(g), int(s)])
            lat[s * n + j] = rng.standard_normal(shape, dtype=np.float32)
    return lat


def save_images(images, paths):
    """images: (N, H, W, 3) float in [-1, 1], or already-quantised uint8
    (passed through), as numpy or a tensor -> PNG files."""
    from PIL import Image
    if isinstance(images, torch.Tensor):
        images = images.detach().cpu().numpy()
    arr = np.asarray(images)
    if arr.dtype != np.uint8:
        # round to nearest, as diffusers' numpy_to_pil does
        arr = np.rint(np.clip((arr + 1.0) * 127.5, 0, 255)).astype(np.uint8)
    for img, path in zip(arr, paths):
        Image.fromarray(img).save(path)


def device_uint8(images):
    """[-1, 1] float images -> uint8 on their device, rounded to nearest as
    ``save_images`` rounds: what the PNG holds, read back at a quarter of
    the bytes."""
    x = (images.float() + 1.0) * 127.5
    return torch.round(torch.clamp(x, 0, 255)).to(torch.uint8)


def device_select_best(images, gt_u8, num_samples: int):
    """Best-of-N SSIM selection on the images' device.

    ``images``: (num_samples * n, H, W2, 3) float in [-1, 1], sample-major
    (``images[s * n + j]`` is sample ``s`` of item ``j``); ``gt_u8``:
    (n, H, W, 3) uint8 targets (numpy or tensor); for W < W2 the candidates
    are cropped to their right W columns (the stage-2 canvas's generated
    half). Candidates are quantised to uint8 first (what the PNG holds and
    the host path scores), both sides scored as uint8 / 255 with
    ``eval.ssim.ssim`` (win 7, data range 1), and the first maximum wins, as
    ``np.argmax``. Returns (best_u8 (n, H, W, 3) uint8, best_idx (n,))."""
    from pcdms_tpu_torch.eval.ssim import ssim
    gt = torch.as_tensor(np.asarray(gt_u8) if not isinstance(
        gt_u8, torch.Tensor) else gt_u8).to(images.device)
    n, h, w = gt.shape[:3]
    u8 = device_uint8(images)[:, :, -w:, :]
    cands = u8.reshape(num_samples, n, h, w, 3)
    gt01 = (gt.float() / 255.0).repeat(num_samples, 1, 1, 1)
    scores = ssim(cands.reshape(num_samples * n, h, w, 3).float() / 255.0,
                  gt01).reshape(num_samples, n)
    best = torch.argmax(scores, dim=0)
    return cands[best, torch.arange(n, device=images.device)], best


def queue_readback(t: torch.Tensor):
    """Queue a copy of ``t`` to the host behind the work that makes it; ->
    (host tensor, event or None). ``wait_readback`` blocks on the event
    only, so later batches' work on the stream keeps running meanwhile."""
    if not t.is_cuda:
        return t.clone(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def wait_readback(host, event) -> np.ndarray:
    """The host copy of ``queue_readback``, once it has landed."""
    if event is not None:
        event.synchronize()
    return host.numpy()
