"""End-to-end learning proof (counterpart of ``scripts/learning_proof.py``):
the three trainers of the port *learn* pose transfer, through the real
CLIs, on the card (``--device cpu`` to run on the CPU).

Protocol:

 0. Generate the synthetic pose-transfer world (``data/synthetic.py``) in
    the DeepFashion layout.
 1. Pre-train the tiny VAE on it (``train/vae.py``) and freeze it, with
    random tiny CLIP / DINOv2 encoders, into the bundle every stage trains
    and samples against (``train/frozen.py``). Record the reconstruction
    ceiling, the SSIM (7x7 windows) of decode(encode(GT)), which the
    diffusion stages cannot pass.
 2. Stage 1: train the prior through ``cli/stage1_train`` (and a 1-step
    "init" run from the same seed); run ``cli/stage1_batchtest`` on the
    test pairs for both checkpoints: the cosine to the target CLIP
    embeddings, and the ``.npy`` embeddings for stage 2.
 3. Stage 2: train through ``cli/stage2_train`` (and a 1-step init); run
    ``cli/stage2_batchtest`` on the test pairs from stage 1's embeddings
    for both checkpoints, and on the train pairs with the GT CLIP
    embeddings (stage 3's training inputs).
 4. Stage 3: train the refiner on stage 2's train-split outputs (and a
    1-step init); refine stage 2's test outputs with both checkpoints.
 5. Score the generations with ``eval/metrics.py::ReconstructionMetrics``
    at the 176x256 protocol and write ``learning_proof.json``.

The port draws its randomness from ``torch.Generator`` streams, not JAX's,
so its numbers are its own; it is held to the JAX test's thresholds
(``--assert_improves``, ``ASSERTIONS``). ``--quick`` is the JAX script's
budget but for stage 3 (``_apply_quick``). It runs as a world of 1 with
the JAX run's global batch. The tiny configurations run no CUDA kernel of
the port (``use_flash=False``).

    python -m pcdms_tpu_torch.cli.learning_proof --root /tmp/lp --quick \\
        --assert_improves [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

logger = logging.getLogger("pcdms_tpu_torch.learning_proof")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--root", type=str, required=True,
                   help="working dir (dataset, checkpoints, outputs)")
    p.add_argument("--identities", type=int, default=6)
    p.add_argument("--poses", type=int, default=8)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vae_steps", type=int, default=1200)
    p.add_argument("--stage1_steps", type=int, default=1000)
    p.add_argument("--stage2_steps", type=int, default=2000)
    p.add_argument("--stage3_steps", type=int, default=800)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--num_inference_steps", type=int, default=12)
    p.add_argument("--num_images_per_prompt", type=int, default=2)
    p.add_argument("--quick", action="store_true",
                   help="CI budget: tiny world, ~1/4 the steps (stage 3: "
                        "3/4, see _apply_quick)")
    p.add_argument("--assert_improves", action="store_true",
                   help="fail unless trained beats init by the thresholds")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def _apply_quick(args):
    """The JAX script's quick budget, but 600 stage-3 steps where it has 150:
    at 150 the stage-3 SSIM gain over the 1-step init is within the spread
    of the init itself, and the 0.012 threshold holds at some seeds only,
    in the JAX package too (seeds 0 / 1 / 2: +0.031 / -0.005 / +0.008);
    at 600 the port gains 3-6 times the threshold."""
    args.identities = 4
    args.poses = 6
    args.vae_steps = 250
    args.stage1_steps = 200
    args.stage2_steps = 350
    args.stage3_steps = 600
    args.batch_size = 8
    args.num_inference_steps = 6
    return args


# ---------------------------------------------------------------------------
# step 1: VAE pre-training and the frozen bundle
# ---------------------------------------------------------------------------

def pretrain_vae_and_bundle(args, train_json) -> float:
    """Fit the tiny VAE on the world's images and freeze {vae, clip, dino};
    returns the VAE's reconstruction SSIM ceiling."""
    import numpy as np
    import torch

    from pcdms_tpu_torch.cli.common import tiny_configs
    from pcdms_tpu_torch.data.datasets import PairList
    from pcdms_tpu_torch.data.preprocess import load_image, to_neg1_1
    from pcdms_tpu_torch.eval.metrics import compare_ssim
    from pcdms_tpu_torch.models.vae import AutoencoderKL
    from pcdms_tpu_torch.models.vit import VisionTransformer
    from pcdms_tpu_torch.train.common import TrainConfig
    from pcdms_tpu_torch.train.frozen import save_frozen
    from pcdms_tpu_torch.train.loop import run_training
    from pcdms_tpu_torch.train.vae import vae_draws, vae_pretrain_loss
    from pcdms_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    tiny = tiny_configs()
    size = (args.size, args.size)
    pairs = PairList(train_json, args.root)
    # every distinct image of the world, and one black frame (the masked
    # canvas's right half must encode and decode cleanly too)
    names = sorted({p["source_image"] for p in pairs.pairs}
                   | {p["target_image"] for p in pairs.pairs})
    imgs = np.stack([to_neg1_1(load_image(pairs.image_path(n), size))
                     for n in names] + [np.full(size + (3,), -1.0,
                                                np.float32)])
    logger.info("VAE pretrain set: %s", imgs.shape)

    def batches():
        rng = np.random.default_rng(args.seed)
        while True:
            idx = rng.integers(0, len(imgs), args.batch_size)
            yield {"image": imgs[idx]}

    down = 2 ** (len(tiny.vae.block_out_channels) - 1)
    latent_hw = (args.size // down, args.size // down)

    def loss_fn(models, batch, generator):
        draws = vae_draws(generator, batch["image"].shape[0], latent_hw,
                          tiny.vae.latent_channels, device=device)
        return vae_pretrain_loss(models["vae"], batch, draws)

    torch.manual_seed(args.seed)
    with torch.device(device):
        vae = AutoencoderKL(tiny.vae)
    tcfg = TrainConfig(learning_rate=2e-3, lr_warmup_steps=20,
                       max_train_steps=args.vae_steps, noise_offset=0.0)
    run_training(loss_fn, {"vae": vae}, batches(), tcfg, device=device,
                 seed=args.seed, log_every=100)
    vae.eval()

    torch.manual_seed(args.seed + 1)
    with torch.device(device):
        clip, dino = VisionTransformer(tiny.clip), VisionTransformer(tiny.dino)
    save_frozen(os.path.join(args.root, "frozen"),
                {"vae": vae, "clip": clip, "dino": dino})

    # reconstruction ceiling: decode(encode(GT)) SSIM at the native size
    with torch.no_grad():
        x = torch.from_numpy(imgs[:-1]).to(device)
        recon = vae.decode(vae.encode(x)).clamp(-1, 1).cpu().numpy()
    ceiling = float(np.mean([
        compare_ssim((r + 1) / 2, (g + 1) / 2, data_range=1.0, win_size=7)
        for r, g in zip(recon, imgs[:-1])]))
    logger.info("VAE recon SSIM ceiling: %.4f", ceiling)
    return ceiling


# ---------------------------------------------------------------------------
# steps 2-4: train and sample each stage through the real CLIs
# ---------------------------------------------------------------------------

def _train(stage: int, args, out_name: str, steps: int, extra=()):
    """Run ``cli/stage{N}_train.main`` in this process; -> (its output dir,
    seconds)."""
    mod = __import__(f"pcdms_tpu_torch.cli.stage{stage}_train",
                     fromlist=["main"])
    out = os.path.join(args.root, out_name)
    argv = [
        "--output_dir", out,
        "--json_path", os.path.join(args.root, "train_pairs.json"),
        "--image_root_path", args.root,
        "--img_height", str(args.size), "--img_width", str(args.size),
        "--train_batch_size", str(args.batch_size),
        "--max_train_steps", str(steps),
        "--checkpointing_steps", str(max(steps, 1)),
        "--learning_rate", str(args.learning_rate),
        "--lr_warmup_steps", str(min(50, max(steps // 4, 1))),
        "--noise_offset", "0.0",
        "--seed", str(args.seed),
        "--random_init", "--tiny_config", "--mixed_precision", "no",
        "--frozen_dir", os.path.join(args.root, "frozen"),
        "--log_every", "100",
        "--dataloader_num_workers", "0",
        "--device", args.device,
    ] + list(extra)
    t0 = time.time()
    mod.main(argv)
    seconds = time.time() - t0
    logger.info("stage-%d %s: %d steps in %.1fs", stage, out_name, steps,
                seconds)
    return out, seconds


def _batchtest(stage: int, args, ckpt_dir: str, save_name: str,
               json_name: str, extra=()):
    """Run ``cli/stage{N}_batchtest.main`` in this process; -> (its save dir,
    seconds)."""
    mod = __import__(f"pcdms_tpu_torch.cli.stage{stage}_batchtest",
                     fromlist=["main"])
    out = os.path.join(args.root, save_name)
    argv = [
        "--json_path", os.path.join(args.root, json_name),
        "--image_root_path", args.root,
        "--save_path", out,
        "--num_inference_steps", str(args.num_inference_steps),
        "--batch_size", "8",
        "--seed", str(args.seed + 42),
        "--tiny_config",
        "--train_ckpt_dir", ckpt_dir,
        "--frozen_dir", os.path.join(args.root, "frozen"),
        "--device", args.device,
    ] + list(extra)
    if stage != 1:
        argv += ["--img_height", str(args.size),
                 "--img_width", str(args.size),
                 "--num_images_per_prompt",
                 str(args.num_images_per_prompt),
                 "--scheduler", "unipc"]
    t0 = time.time()
    mod.main(argv)
    seconds = time.time() - t0
    logger.info("stage-%d batchtest -> %s (%.1fs)", stage, save_name,
                seconds)
    return out, seconds


def _cosine_from_results(save_dir: str) -> float:
    with open(os.path.join(save_dir, "a_results.txt")) as f:
        return float(f.read().strip().split()[-1])


def _metrics(args, gen_dir: str) -> dict:
    """SSIM / PSNR / L1 / MAE of the generations against their GT at the
    176x256 protocol (FID and LPIPS need pretrained networks)."""
    from pcdms_tpu_torch.eval.metrics import (
        ReconstructionMetrics, preprocess_path_for_deform_task,
    )
    gt_dir = os.path.join(args.root, "train_all_png")
    gt_list, distorted = preprocess_path_for_deform_task(gt_dir, gen_dir)
    rec = ReconstructionMetrics().calculate_from_disk(
        distorted, gt_list, save_path=gen_dir, img_size=(176, 256),
        sort=False)
    return {k: float(v[0]) for k, v in rec.items()}


# the JAX package's slow test (tests/test_learning_proof.py), about half the
# gains it measured at the quick budget: (description, holds(results))
ASSERTIONS = [
    ("stage-1 cosine gain > 0.25",
     lambda r: r["stage1_cosine_trained"] - r["stage1_cosine_init"] > 0.25),
    ("stage-1 trained cosine > 0.9",
     lambda r: r["stage1_cosine_trained"] > 0.9),
    ("stage-2 SSIM gain > 0.015",
     lambda r: r["stage2_trained"]["ssim"] > r["stage2_init"]["ssim"] + 0.015),
    ("stage-2 PSNR gain > 1.5 dB",
     lambda r: r["stage2_trained"]["psnr"] > r["stage2_init"]["psnr"] + 1.5),
    ("stage-2 L1 drop > 0.05",
     lambda r: r["stage2_trained"]["l1"] < r["stage2_init"]["l1"] - 0.05),
    ("stage-3 SSIM gain > 0.012",
     lambda r: r["stage3_trained"]["ssim"] > r["stage3_init"]["ssim"] + 0.012),
    ("stage-3 L1 drop > 0.02",
     lambda r: r["stage3_trained"]["l1"] < r["stage3_init"]["l1"] - 0.02),
    ("VAE ceiling > 0.5", lambda r: r["vae_recon_ssim_ceiling"] > 0.5),
    ("stage-2 trained SSIM under the VAE ceiling",
     lambda r: r["stage2_trained"]["ssim"] < r["vae_recon_ssim_ceiling"]),
]


def main(argv=None):
    """Returns the results that ``learning_proof.json`` holds."""
    logging.basicConfig(
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
        level=logging.INFO)
    args = parse_args(argv)
    if args.quick:
        args = _apply_quick(args)
    os.makedirs(args.root, exist_ok=True)
    t_start = time.time()
    results = {"config": vars(args).copy()}
    seconds = {}

    from pcdms_tpu_torch.data.synthetic import generate_dataset
    train_json, _ = generate_dataset(
        args.root, n_identities=args.identities, n_poses=args.poses,
        size=args.size, seed=args.seed)
    logger.info("world: %d identities x %d poses at %dpx",
                args.identities, args.poses, args.size)

    t0 = time.time()
    results["vae_recon_ssim_ceiling"] = pretrain_vae_and_bundle(
        args, train_json)
    seconds["vae"] = time.time() - t0

    def train(stage, name, steps, extra=()):
        out, s = _train(stage, args, name, steps, extra)
        seconds[name] = s
        return out

    def batchtest(stage, ckpt, name, json_name, extra=()):
        out, s = _batchtest(stage, args, ckpt, name, json_name, extra)
        seconds[name] = s
        return out

    # ---- stage 1 ----
    s1_init = train(1, "s1_init", 1)
    s1_ckpt = train(1, "s1", args.stage1_steps)
    d = batchtest(1, s1_init, "s1_out_init", "test_pairs.json")
    results["stage1_cosine_init"] = _cosine_from_results(d)
    s1_npy = batchtest(1, s1_ckpt, "s1_out", "test_pairs.json")
    results["stage1_cosine_trained"] = _cosine_from_results(s1_npy)
    logger.info("stage-1 cosine: init %.4f -> trained %.4f",
                results["stage1_cosine_init"],
                results["stage1_cosine_trained"])

    # ---- stage 2 ----
    s2_init = train(2, "s2_init", 1)
    s2_ckpt = train(2, "s2", args.stage2_steps)
    d = batchtest(2, s2_init, "s2_out_init", "test_pairs.json",
                  ["--prior_embeds_dir", s1_npy])
    results["stage2_init"] = _metrics(args, d)
    s2_test = batchtest(2, s2_ckpt, "s2_out", "test_pairs.json",
                        ["--prior_embeds_dir", s1_npy])
    results["stage2_trained"] = _metrics(args, s2_test)
    # train-split generations from the GT CLIP embeddings: stage 3's inputs
    s2_train_gen = batchtest(2, s2_ckpt, "s2_out_train", "train_pairs.json")
    logger.info("stage-2 ssim: init %.4f -> trained %.4f",
                results["stage2_init"]["ssim"],
                results["stage2_trained"]["ssim"])

    # ---- stage 3 ----
    gen = ["--gen_dir", s2_train_gen, "--gen_drop_rate", "0.1"]
    s3_init = train(3, "s3_init", 1, gen)
    s3_ckpt = train(3, "s3", args.stage3_steps, gen)
    d = batchtest(3, s3_init, "s3_out_init", "test_pairs.json",
                  ["--gen_dir", s2_test])
    results["stage3_init"] = _metrics(args, d)
    d = batchtest(3, s3_ckpt, "s3_out", "test_pairs.json",
                  ["--gen_dir", s2_test])
    results["stage3_trained"] = _metrics(args, d)
    logger.info("stage-3 ssim: init %.4f -> trained %.4f",
                results["stage3_init"]["ssim"],
                results["stage3_trained"]["ssim"])

    results["wall_s"] = round(time.time() - t_start, 1)
    results["seconds"] = {k: round(v, 2) for k, v in seconds.items()}
    with open(os.path.join(args.root, "learning_proof.json"), "w") as f:
        json.dump(results, f, indent=2)

    print("\n== learning proof ==")
    print(f"VAE recon SSIM ceiling:      "
          f"{results['vae_recon_ssim_ceiling']:.4f}")
    print(f"stage-1 cosine sim:          "
          f"{results['stage1_cosine_init']:.4f} -> "
          f"{results['stage1_cosine_trained']:.4f}")
    for st in (2, 3):
        i, t = results[f"stage{st}_init"], results[f"stage{st}_trained"]
        print(f"stage-{st} SSIM / PSNR / L1:   "
              f"{i['ssim']:.4f} / {i['psnr']:.2f} / {i['l1']:.4f} -> "
              f"{t['ssim']:.4f} / {t['psnr']:.2f} / {t['l1']:.4f}")
    print(f"(wall: {results['wall_s']}s; artifacts in {args.root})")

    if args.assert_improves:
        failed = [name for name, holds in ASSERTIONS if not holds(results)]
        if failed:
            raise AssertionError(f"the system does not learn: {failed}")
        print("ASSERTIONS PASSED: the system learns")
    return results


if __name__ == "__main__":
    main()
