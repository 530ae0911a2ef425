"""Stage-1 batch test CLI (counterpart of ``pcdms_tpu/cli/stage1_batchtest.py``,
flag-compatible with it). Runs on the CUDA card unless ``--device cpu``.

For every test pair: the CLIP ViT-H embeddings of the source and target
images, the source / target pose keypoints from the ``normalized_pose_txt``
files, and the prior's UnCLIP sampling of the target embedding. Each
prediction is written as ``{src}_to_{tgt}.npy`` (the handoff to the stage-2
batch test's ``--prior_embeds_dir``), and the mean cosine similarity to the
ground-truth target embeddings is appended to ``a_results.txt``.

    python -m pcdms_tpu_torch.cli.stage1_batchtest --random_init \\
        --json_path test_pairs.json --image_root_path <root> --save_path out

Weights: the reference's files (``--weights_name``, the trained prior;
``--image_encoder_path``, CLIP ViT-H; ``compat/load.py``), ``--random_init``
(from ``--seed``), or a port training run's checkpoint
(``--train_ckpt_dir``, its ``prior``) with the frozen-encoder bundle it
used (``--frozen_dir``, its ``clip``). The prior runs in f32; the
CLIP encoder keeps f32 weights and computes in bf16, on the source and
target images of a batch in one pass.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from pcdms_tpu_torch.cli.common import (
    build_cli_models, check_weight_flags, global_indices,
    process_shard, queue_readback, setup_logging, tiny_configs,
    wait_readback,
)
from pcdms_tpu_torch.data.datasets import pair_stem
from pcdms_tpu_torch.parallel.mesh import make_mesh, sum_over_world

logger = logging.getLogger("pcdms_tpu_torch.stage1_batchtest")

_PRETRAINED_FLAGS = ("weights_name", "image_encoder_path")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--json_path", type=str, required=True)
    p.add_argument("--image_root_path", type=str, default="")
    p.add_argument("--img_path", type=str, default=None,
                   help="unused; flag parity")
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--weights_name", type=str, default=None,
                   help="trained prior checkpoint (a state dict file)")
    p.add_argument("--image_encoder_path", type=str, default=None,
                   help="CLIP ViT-H dir")
    p.add_argument("--num_inference_steps", type=int, default=20)
    p.add_argument("--guidance_scale", type=float, default=0.0)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--tiny_config", action="store_true",
                   help="tiny-geometry models (CPU smoke runs)")
    p.add_argument("--train_ckpt_dir", type=str, default=None,
                   help="checkpoint dir of a port stage-1 training run: its "
                        "trained prior (EMA if tracked); pair with "
                        "--frozen_dir")
    p.add_argument("--frozen_dir", type=str, default=None,
                   help="frozen-encoder bundle (train/frozen.py) with clip")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Exit where the JAX CLI cannot go on (``cli/common.py``)."""
    check_weight_flags(args, _PRETRAINED_FLAGS,
                       "the CLIP encoder the run trained against")


def build_models(args, device):
    """({"prior"} in f32, the CLIP encoder in f32) on ``device``."""
    from pcdms_tpu_torch.models.prior_transformer import (
        PriorConfig, PriorTransformer,
    )
    from pcdms_tpu_torch.models.vit import (
        VisionTransformer, clip_vit_h14_config,
    )
    if args.tiny_config:
        tiny = tiny_configs()
        prior_cfg, clip_cfg = tiny.prior, tiny.clip
    else:
        prior_cfg, clip_cfg = PriorConfig(), clip_vit_h14_config()

    def pretrained():
        from pcdms_tpu_torch.compat.load import (
            load_clip_vision, load_state_dict, split_reference_checkpoint,
        )
        sd = load_state_dict(args.weights_name)
        return {"prior": split_reference_checkpoint(sd).get("prior", sd),
                "clip": load_clip_vision(args.image_encoder_path)}

    models = build_cli_models(
        args, {"prior": lambda: PriorTransformer(prior_cfg)},
        {"clip": lambda: VisionTransformer(clip_cfg)}, device, pretrained)
    clip = models.pop("clip")
    return models, clip


def main(argv=None):
    """Run the batch test; returns the paths of the .npy files written."""
    setup_logging()
    args = parse_args(argv)
    check_supported(args)
    mesh = make_mesh(args.device)
    device = mesh.device
    os.makedirs(args.save_path, exist_ok=True)

    from pcdms_tpu_torch.data.datasets import PairList
    from pcdms_tpu_torch.data.preprocess import clip_preprocess, load_image
    from pcdms_tpu_torch.eval.metrics import cosine_similarity
    from pcdms_tpu_torch.pipelines.stage1_prior import stage1_generate
    from pcdms_tpu_torch.pose.keypoints import read_pose_txt
    from pcdms_tpu_torch.train.encoders import clip_image_embed

    pairs = PairList(args.json_path, args.image_root_path).shard(
        *process_shard(mesh))
    models, clip = build_models(args, device)
    items, bs, written, sims = pairs.pairs, args.batch_size, [], []
    t0 = time.time()

    def finish(pending):
        """Wait for one batch's readback; write its .npy files and score
        it."""
        chunk, pred_rb, t_embed_rb, start = pending
        pred, t_embed = wait_readback(*pred_rb), wait_readback(*t_embed_rb)
        for i, item in enumerate(chunk):
            path = os.path.join(args.save_path, f"{pair_stem(item)}.npy")
            np.save(path, pred[i:i + 1])
            written.append(path)
        sims.extend(cosine_similarity(pred, t_embed).tolist())
        logger.info("processed %d/%d", min(start + bs, len(items)),
                    len(items))

    pending = None
    for start in range(0, len(items), bs):
        chunk = items[start:start + bs]
        s_pix, t_pix = (np.stack([
            clip_preprocess(load_image(pairs.image_path(i[key])))
            for i in chunk]) for key in ("source_image", "target_image"))
        s_pose, t_pose = (np.stack([
            read_pose_txt(pairs.pose_txt_path(i[key])) for i in chunk])
            for key in ("source_image", "target_image"))
        with torch.inference_mode():
            # one encoder pass (and one cast of its weights) for both sides
            s_embed, t_embed = clip_image_embed(
                clip, np.concatenate([s_pix, t_pix])).chunk(2)
            pred = stage1_generate(
                models, s_embed, s_pose, t_pose,
                generator=torch.Generator(device=device).manual_seed(
                    args.seed + global_indices(start, 1, mesh)[0]),
                num_steps=args.num_inference_steps,
                guidance_scale=args.guidance_scale, device=device)
            batch = (chunk, queue_readback(pred), queue_readback(t_embed),
                     start)
        if pending is not None:
            finish(pending)
        pending = batch

    if pending is not None:
        finish(pending)
    # the world's mean, written once
    total = sum_over_world([float(np.sum(sims)), float(len(sims))], mesh)
    mean_sim = total[0] / total[1]
    logger.info("mean cosine similarity: %.5f (%.1fs)", mean_sim,
                time.time() - t0)
    if mesh.is_main:
        with open(os.path.join(args.save_path, "a_results.txt"), "a") as f:
            f.write(f"{args.weights_name}  {mean_sim}\n")
    return written


if __name__ == "__main__":
    main()
