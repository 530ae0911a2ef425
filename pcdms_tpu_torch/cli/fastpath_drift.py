"""Quality drift of the approximate fast sampling paths against the exact
sampler (counterpart of ``scripts/fastpath_drift.py``, with the same flags
plus ``--device``), on the CUDA card unless ``--device cpu``.

Each fast path's output is compared with the exact 50-step DDIM sampler's
under the same conditions: the same weights, inputs and initial latents, the
VAE's posterior mean. Two legitimate sampler swaps calibrate the table
(20-step UniPC, the reference's batch-test protocol, and 20-step DDIM); the
approximations are encoder propagation at intervals 2 and 3 and 4-step LCM
on the zero-init w-projection student (``init_student_from_teacher``),
whose function equals the teacher's, so its row is the sampler's structural
drift alone. Per variant: PSNR of the decoded [-1, 1] images (data range
2.0) and the cosine of the flattened images.

Random weights (default): the stage-2 geometry at ``--height`` (the canvas
is twice as wide), bf16, seeded inputs; a random UNet's eps field is rougher
than a trained one's, so these drifts are a conservative proxy.
Trained mode (``--train_ckpt_dir`` + ``--frozen_dir`` + ``--data_root``):
the port's own tiny stage-2 checkpoint (``step_<N>.pt`` of
``cli/stage2_train.py``, as the learning proof writes it) on its test pairs
with its frozen bundle and oracle CLIP conditioning, each row also scored by
SSIM against the ground truth; ``--lcm_ckpt_dir`` (``cli/lcm_distill.py``'s
output) adds the distilled 4-step student.

    python -m pcdms_tpu_torch.cli.fastpath_drift [--tiny --device cpu]
    python -m pcdms_tpu_torch.cli.fastpath_drift --train_ckpt_dir lp/s2 \\
        --frozen_dir lp/frozen --data_root lp [--lcm_ckpt_dir lp/lcm] \\
        --device cpu
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import time

import numpy as np
import torch

LCM_COND_DIM = 256
# LCM's draws between steps, and trained mode's initial latents
LCM_GEN_SEED = 7
TRAINED_LATENT_SEED = 0


def psnr(a, b, data_range=2.0) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    mse = float(np.mean((a - b) ** 2, dtype=np.float64))
    return 10.0 * np.log10(data_range ** 2 / mse)


def cosine(a, b) -> float:
    a = np.ravel(np.asarray(a, np.float64))
    b = np.ravel(np.asarray(b, np.float64))
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny configs (CPU smoke of the harness itself)")
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--exact_steps", type=int, default=50)
    ap.add_argument("--train_ckpt_dir", type=str, default=None,
                    help="the port's stage-2 training checkpoint dir (tiny "
                         "config, e.g. the learning-proof run)")
    ap.add_argument("--frozen_dir", type=str, default=None,
                    help="the run's frozen {vae, clip, dino} bundle")
    ap.add_argument("--data_root", type=str, default=None,
                    help="synthetic-world root (test_pairs.json) for real "
                         "inputs in trained mode")
    ap.add_argument("--lcm_ckpt_dir", type=str, default=None,
                    help="cli/lcm_distill output: score the DISTILLED "
                         "4-step student as well")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap.parse_args(argv)


def random_setup(tiny: bool, height: int, batch: int, device,
                 seed: int = 0):
    """Random-weights mode: ({unet, image_proj, pose_proj, vae} in bf16 on
    ``device``, drawn from ``seed``; the inputs (vae_image, st_pose,
    dino_features, t_embed) and the initial latents as f32 numpy, drawn
    from ``seed`` by numpy)."""
    from pcdms_tpu_torch.models.projections import (
        ImageProjModel, PoseCondEmbedding,
    )
    from pcdms_tpu_torch.models.unet2d import (
        UNet2DConditionModel, stage2_unet_config,
    )
    from pcdms_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    if tiny:
        from pcdms_tpu_torch.cli.common import tiny_configs
        t = tiny_configs()
        unet_cfg, vae_cfg = t.unet2(True), t.vae
        ip_kw, pp_kw = t.image_proj_kwargs, t.pose_proj_kwargs
        dino_shape, embed_dim, height = (5, t.dino.hidden_size), t.clip_dim, 64
    else:
        unet_cfg, vae_cfg = stage2_unet_config(), VAEConfig()
        ip_kw, pp_kw = {}, {}
        dino_shape, embed_dim = (257, 1536), 1024
    torch.manual_seed(seed)
    with torch.device(device):
        models = {"unet": UNet2DConditionModel(unet_cfg),
                  "image_proj": ImageProjModel(**ip_kw),
                  "pose_proj": PoseCondEmbedding(**pp_kw),
                  "vae": AutoencoderKL(vae_cfg)}
    models = {k: m.eval().to(torch.bfloat16) for k, m in models.items()}
    rng = np.random.default_rng(seed)
    width, b = 2 * height, batch
    inputs = (
        rng.uniform(-1, 1, (b, height, width, 3)).astype(np.float32),
        rng.uniform(-1, 1, (b, height, width, 3)).astype(np.float32),
        rng.standard_normal((b,) + dino_shape).astype(np.float32),
        rng.standard_normal((b, 1, embed_dim)).astype(np.float32))
    latents = rng.standard_normal(
        (b, height // 8, width // 8, 4)).astype(np.float32)
    return models, inputs, latents


def trained_setup(args, device):
    """Trained mode: (models in f32 from ``--train_ckpt_dir`` and the
    frozen VAE, inputs from the first ``--batch`` test pairs of
    ``--data_root``, latents drawn from ``TRAINED_LATENT_SEED``, the pairs'
    targets as uint8 arrays)."""
    from pcdms_tpu_torch.cli.common import tiny_configs
    from pcdms_tpu_torch.data.datasets import PairList
    from pcdms_tpu_torch.data.preprocess import (
        black_like, clip_preprocess, load_image, make_side_by_side, to_neg1_1,
    )
    from pcdms_tpu_torch.models.projections import (
        ImageProjModel, PoseCondEmbedding,
    )
    from pcdms_tpu_torch.models.unet2d import UNet2DConditionModel
    from pcdms_tpu_torch.models.vae import AutoencoderKL
    from pcdms_tpu_torch.models.vit import VisionTransformer
    from pcdms_tpu_torch.train.encoders import clip_image_embed, dino_features
    from pcdms_tpu_torch.train.frozen import (
        load_frozen_modules, load_trained_params,
    )

    t = tiny_configs()
    trained = load_trained_params(args.train_ckpt_dir)
    with torch.device(device):
        models = {"unet": UNet2DConditionModel(t.unet2(True)),
                  "image_proj": ImageProjModel(**t.image_proj_kwargs),
                  "pose_proj": PoseCondEmbedding(**t.pose_proj_kwargs)}
        for name, m in models.items():
            m.load_state_dict(trained[name])
        frozen = load_frozen_modules(args.frozen_dir, {
            "vae": lambda: AutoencoderKL(t.vae),
            "clip": lambda: VisionTransformer(t.clip),
            "dino": lambda: VisionTransformer(t.dino)})
    models["vae"] = frozen["vae"]
    models = {k: m.eval() for k, m in models.items()}

    plist = PairList(os.path.join(args.data_root, "test_pairs.json"),
                     args.data_root)
    pairs = plist.pairs[:args.batch]
    size = (64, 64)

    def load(paths):
        return [load_image(p, size) for p in paths]
    s_imgs = load(plist.image_path(p["source_image"]) for p in pairs)
    t_imgs = load(plist.image_path(p["target_image"]) for p in pairs)
    s_poses = load(plist.pose_img_path(p["source_image"]) for p in pairs)
    t_poses = load(plist.pose_img_path(p["target_image"]) for p in pairs)
    vae_image = np.stack([to_neg1_1(make_side_by_side(s, black_like(s)))
                          for s in s_imgs])
    st_pose = np.stack([to_neg1_1(make_side_by_side(sp, tp))
                        for sp, tp in zip(s_poses, t_poses)])
    dino = dino_features(frozen["dino"].eval(), np.stack(
        [clip_preprocess(s) for s in s_imgs])).cpu().numpy()
    # oracle (train-mode) conditioning: the target's own CLIP embedding
    t_embed = clip_image_embed(frozen["clip"].eval(), np.stack(
        [clip_preprocess(ti) for ti in t_imgs])).cpu().numpy()[:, None, :]
    b = len(pairs)
    latents = np.random.default_rng(TRAINED_LATENT_SEED).standard_normal(
        (b, 8, 16, 4)).astype(np.float32)
    targets = [np.asarray(ti, np.uint8) for ti in t_imgs]
    return models, (vae_image, st_pose, dino, t_embed), latents, targets


def lcm_student(models):
    """The teacher-equal LCM student: the UNet with a zero-init
    w-projection of ``LCM_COND_DIM``, in the teacher's dtype."""
    from pcdms_tpu_torch.train.lcm_distill import init_student_from_teacher
    unet = models["unet"]
    cfg = dataclasses.replace(unet.cfg, time_cond_proj_dim=LCM_COND_DIM)
    dtype = next(unet.parameters()).dtype
    student = init_student_from_teacher(unet, cfg).eval().to(dtype)
    return dict(models, unet=student)


def distilled_student(lcm_ckpt_dir, models):
    """The distilled student of ``cli/lcm_distill.py`` with ``models``'
    VAE."""
    from pcdms_tpu_torch.train.frozen import load_trained_params
    trained = load_trained_params(lcm_ckpt_dir)
    out = lcm_student(models)
    out.update({k: copy.deepcopy(out[k]) for k in ("image_proj",
                                                   "pose_proj")})
    for name in ("unet", "image_proj", "pose_proj"):
        out[name].load_state_dict(trained[name])
    return out


def make_gen(inputs, latents, device, compute_dtype=torch.bfloat16):
    """-> gen(models, steps, scheduler="ddim", interval=1): the decoded
    (B, H, 2W, 3) f32 numpy images of ``stage2_generate`` at CFG 2.0 from
    the given latents, the VAE's posterior mean; LCM's draws between steps
    come from a generator seeded ``LCM_GEN_SEED`` on ``device``."""
    from pcdms_tpu_torch.pipelines.stage2_inpaint import stage2_generate

    def gen(models, steps, scheduler="ddim", interval=1):
        out = stage2_generate(
            models, *inputs,
            generator=torch.Generator(device=device).manual_seed(
                LCM_GEN_SEED),
            latents=latents, num_steps=steps, guidance_scale=2.0,
            scheduler=scheduler, encoder_cache_interval=interval,
            deterministic_vae=True, compute_dtype=compute_dtype,
            device=device)
        return out.float().cpu().numpy()
    return gen


def variants(gen, models, exact_steps: int, distilled=None):
    """[(name, thunk)] of the table's rows, each thunk -> images."""
    student = lcm_student(models)
    rows = [
        ("UniPC 20 (reference batch-test protocol)",
         lambda: gen(models, 20, scheduler="unipc")),
        ("DDIM 20", lambda: gen(models, 20)),
        (f"enc-prop interval 2 (DDIM {exact_steps})",
         lambda: gen(models, exact_steps, interval=2)),
        (f"enc-prop interval 3 (DDIM {exact_steps})",
         lambda: gen(models, exact_steps, interval=3)),
        ("LCM 4-step (teacher-equal student, undistilled floor)",
         lambda: gen(student, 4, scheduler="lcm")),
    ]
    if distilled is not None:
        rows.append(("LCM 4-step (DISTILLED student, cli/lcm_distill)",
                     lambda: gen(distilled, 4, scheduler="lcm")))
    return rows


def gt_ssim(out, targets) -> float:
    """Mean SSIM of each image's generated right half, quantised to uint8,
    against its target (what the batch-test protocol scores)."""
    from pcdms_tpu_torch.data.preprocess import to_neg1_1
    from pcdms_tpu_torch.eval.metrics import compare_ssim
    w = out.shape[2] // 2
    vals = []
    for i, ti in enumerate(targets):
        gen_u8 = np.rint(np.clip((out[i, :, w:, :] + 1.0) * 127.5,
                                 0, 255)).astype(np.uint8)
        vals.append(compare_ssim(gen_u8.astype(np.float32) / 127.5 - 1.0,
                                 to_neg1_1(ti), data_range=2.0, win_size=7))
    return float(np.mean(vals))


def main(argv=None):
    """Print the drift table; returns [(name, psnr, cosine, ssim or
    None)]."""
    from pcdms_tpu_torch.utils.device import resolve_device
    args = parse_args(argv)
    device = resolve_device(args.device)
    trained = bool(args.train_ckpt_dir)
    if trained and not (args.frozen_dir and args.data_root):
        raise SystemExit("--train_ckpt_dir needs --frozen_dir and "
                         "--data_root")
    targets, distilled = None, None
    if trained:
        models, inputs, latents, targets = trained_setup(args, device)
        if args.lcm_ckpt_dir:
            distilled = distilled_student(args.lcm_ckpt_dir, models)
    else:
        models, inputs, latents = random_setup(args.tiny, args.height,
                                               args.batch, device)
    gen = make_gen(inputs, latents, device)

    t0 = time.time()
    exact = gen(models, args.exact_steps)
    print(f"# exact DDIM {args.exact_steps}-step reference done "
          f"({time.time() - t0:.0f}s)", flush=True)
    hdr_gt = " SSIM vs GT |" if trained else ""
    print(f"\n| variant | PSNR vs exact (dB) | cosine |{hdr_gt}")
    print("|---|---|---|" + ("---|" if trained else ""))
    if trained:
        print(f"| exact DDIM {args.exact_steps} (reference) | — | — | "
              f"{gt_ssim(exact, targets):.4f} |", flush=True)
    rows = []
    for name, fn in variants(gen, models, args.exact_steps, distilled):
        t0 = time.time()
        out = fn()
        ssim = gt_ssim(out, targets) if trained else None
        rows.append((name, psnr(exact, out), cosine(exact, out), ssim))
        gt_col = f" {ssim:.4f} |" if trained else ""
        print(f"| {name} | {rows[-1][1]:.2f} | {rows[-1][2]:.4f} |{gt_col}"
              f"   <!-- {time.time() - t0:.0f}s -->", flush=True)
    return rows


if __name__ == "__main__":
    main()
