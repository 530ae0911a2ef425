"""LCM distillation CLI (counterpart of ``pcdms_tpu/cli/lcm_distill.py``),
flag-compatible with it: distills the trained stage-2 inpainting UNet into
a w-conditioned latent-consistency student for 4-8 step sampling. Runs on
the CUDA card unless ``--device cpu`` is given.

    python -m pcdms_tpu_torch.cli.lcm_distill \\
        --weights_name stage2_ckpt.pt \\
        --pretrained_model_name_or_path /path/to/sd21 \\
        --image_encoder_p_path /path/to/dinov2-giant \\
        --image_encoder_g_path /path/to/clip-vit-h \\
        --json_path data.json --image_root_path /data --output_dir lcm_out

The student trains on the stage-2 trainer's batches (``cli/stage2_train.py``
``make_batches``, condition dropout off: the teacher supplies the
guidance) through ``train/loop.run_training``, so ``--zero1``,
``--dcn_slices`` (under ``torchrun``), resume, the SIGTERM stop and
``--use_ema`` all apply.

Teacher: random from ``--seed`` (``--random_init``), the reference's
monolithic stage-2 checkpoint (``--weights_name``,
``compat/load.py::load_pcdms_stage2_checkpoint``) or a port stage-2 run's
checkpoint directory (``--train_ckpt_dir``, its EMA when it kept one; pair
it with that run's ``--frozen_dir``). The VAE, CLIP and DINOv2 come from
``--frozen_dir`` or are built as the stage-2 trainer builds them. The
student copies the teacher and adds a zero-initialised w-projection
(``train/lcm_distill.init_student_from_teacher``).

Sample the result with ``stage2_generate(..., scheduler="lcm",
num_steps=4)`` on a UNet of ``time_cond_proj_dim`` 256 (the default).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import logging

import torch

from pcdms_tpu_torch.cli.common import (
    add_common_train_flags, check_train_flags, compute_dtype_from_args,
    frozen_loaders, setup_logging,
    tensorboard_writer_from_args, tiny_configs, train_config_from_args,
)
from pcdms_tpu_torch.parallel.mesh import make_hybrid_mesh

logger = logging.getLogger("pcdms_tpu_torch.lcm_distill")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_train_flags(p)
    p.add_argument("--weights_name", type=str, default=None,
                   help="trained stage-2 monolithic checkpoint: the teacher")
    p.add_argument("--train_ckpt_dir", type=str, default=None,
                   help="checkpoint dir of a port stage-2 training run to "
                        "use as the teacher (EMA preferred); pair it with "
                        "the run's --frozen_dir")
    p.add_argument("--image_encoder_p_path", type=str, default=None)
    p.add_argument("--image_encoder_g_path", type=str, default=None)
    # condition dropout stays off: the student always sees real conditions
    p.add_argument("--imgp_drop_rate", type=float, default=0.0)
    p.add_argument("--imgg_drop_rate", type=float, default=0.0)
    p.add_argument("--num_ddim_timesteps", type=int, default=50)
    p.add_argument("--w_min", type=float, default=1.5)
    p.add_argument("--w_max", type=float, default=4.0)
    p.add_argument("--huber_c", type=float, default=0.001)
    p.add_argument("--time_cond_proj_dim", type=int, default=256)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--tiny_config", action="store_true")
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Exit when the data path lacks its pair list, or a pretrained teacher
    lacks its files (the JAX CLI's exits)."""
    flags = []
    if not (args.train_ckpt_dir and args.frozen_dir):
        flags.append("pretrained_model_name_or_path")
        if not args.synthetic_data:
            flags += ["image_encoder_p_path", "image_encoder_g_path"]
    check_train_flags(args, flags)
    if not (args.random_init or args.weights_name or args.train_ckpt_dir):
        raise SystemExit("--weights_name or --train_ckpt_dir (trained "
                         "stage-2 teacher) required without --random_init")


def build_models(args, device):
    """(teacher {unet, image_proj, pose_proj}, trainable student {unet,
    image_proj, pose_proj}, vae, clip, dino, aux), f32 on ``device``; CLIP
    and DINOv2 only for the DeepFashion data path."""
    from pcdms_tpu_torch.cli.stage2_train import ModelAux
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
    from pcdms_tpu_torch.train.frozen import (
        frozen_dir_or_build, load_frozen_modules, load_trained_params,
    )
    from pcdms_tpu_torch.train.lcm_distill import init_student_from_teacher

    if args.tiny_config:
        tiny = tiny_configs()
        teacher_cfg, vae_cfg = tiny.unet2(with_class_embed=True), tiny.vae
        clip_cfg, dino_cfg = tiny.clip, tiny.dino
        proj_kw, pose_kw = tiny.image_proj_kwargs, tiny.pose_proj_kwargs
        aux = ModelAux(tiny.dino_tokens, tiny.dino_dim, tiny.clip_dim)
    else:
        teacher_cfg, vae_cfg = stage2_unet_config(), VAEConfig()
        clip_cfg, dino_cfg = clip_vit_h14_config(), dinov2_giant_config()
        proj_kw, pose_kw, aux = {}, {}, ModelAux()

    torch.manual_seed(args.seed)
    with torch.device(device):
        teacher = {"unet": UNet2DConditionModel(teacher_cfg),
                   "image_proj": ImageProjModel(**proj_kw),
                   "pose_proj": PoseCondEmbedding(**pose_kw)}
        if args.train_ckpt_dir:
            trained = load_trained_params(args.train_ckpt_dir)
            for name, module in teacher.items():
                module.load_state_dict(trained[name])
        elif not args.random_init:
            from pcdms_tpu_torch.compat.load import (
                load_into, load_pcdms_stage2_checkpoint,
            )
            weights = load_pcdms_stage2_checkpoint(args.weights_name)
            for name in weights:
                load_into(teacher[name], weights[name], name)
        makers = {"vae": lambda: AutoencoderKL(vae_cfg)}
        if not args.synthetic_data:
            makers.update(clip=lambda: VisionTransformer(clip_cfg),
                          dino=lambda: VisionTransformer(dino_cfg))
        if args.train_ckpt_dir and args.frozen_dir:
            frozen = load_frozen_modules(args.frozen_dir, makers)
        else:
            frozen = frozen_dir_or_build(args.frozen_dir,
                                         frozen_loaders(args, makers))
    teacher = {k: m.eval().requires_grad_(False) for k, m in teacher.items()}
    student_cfg = dataclasses.replace(
        teacher_cfg, time_cond_proj_dim=args.time_cond_proj_dim,
        remat=args.gradient_checkpointing)
    trainable = {
        "unet": init_student_from_teacher(teacher["unet"], student_cfg),
        "image_proj": copy.deepcopy(teacher["image_proj"]),
        "pose_proj": copy.deepcopy(teacher["pose_proj"]),
    }
    for module in trainable.values():
        module.requires_grad_(True)
    clip, dino = (None if m is None else m.eval()
                  for m in (frozen.get("clip"), frozen.get("dino")))
    return teacher, trainable, frozen["vae"].eval(), clip, dino, aux


def main(argv=None):
    """Distill; returns the final ``TrainState`` (the student's modules)."""
    setup_logging()
    args = parse_args(argv)
    check_supported(args)
    mesh = make_hybrid_mesh(args.dcn_slices, args.device)
    tcfg = train_config_from_args(args)
    dtype = compute_dtype_from_args(args)

    teacher, trainable, vae, clip, dino, aux = build_models(args, mesh.device)

    from pcdms_tpu_torch.cli.stage2_train import make_batches
    from pcdms_tpu_torch.train.lcm_distill import lcm_distill_loss_fn
    from pcdms_tpu_torch.train.loop import run_training

    loss_fn = lcm_distill_loss_fn(
        teacher, vae, num_ddim_timesteps=args.num_ddim_timesteps,
        w_min=args.w_min, w_max=args.w_max, huber_c=args.huber_c,
        compute_dtype=dtype, mesh=mesh)
    batches = make_batches(args, clip, dino, aux, mesh=mesh)
    # the loss holds the teacher and the VAE in the compute dtype, the
    # batch generator the encoders: no reference here may pin the f32 ones
    del teacher, vae, clip, dino
    return run_training(loss_fn, trainable, batches, tcfg, mesh=mesh,
                        seed=args.seed, output_dir=args.output_dir,
                        checkpointing_steps=args.checkpointing_steps,
                        log_every=args.log_every,
                        resume_from_checkpoint=args.resume_from_checkpoint,
                        profile_dir=args.profile_dir,
                        tensorboard_writer=tensorboard_writer_from_args(args))


if __name__ == "__main__":
    main()
