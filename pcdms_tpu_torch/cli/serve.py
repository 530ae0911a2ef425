"""Online serving CLI (counterpart of ``pcdms_tpu/cli/serve.py``, with the
same flags plus ``--device``): dynamic-batched pose-transfer inference over
HTTP, on the CUDA card unless ``--device cpu``.

It puts the models behind the dynamic-batching engine
(``pcdms_tpu_torch/serve/``) and a stdlib HTTP front end. The request
contract is tensors in, image out (npz bodies, ``serve/http.py``): clients
send the preprocessed canvases, the DINOv2 features and (full variant) the
prior embedding, the stage-2 pipeline's inputs.

Weights: the reference's files (``--weights_name``, the monolithic
stage-2 checkpoint, and the SD-2.1 dir ``--pretrained_model_name_or_path``
for the VAE; for the cascade also ``--stage1_ckpt`` and ``--stage3_ckpt``;
``compat/load.py``), or ``--random_init`` from ``--seed``. Full width
computes in bf16, ``--tiny_config`` in f32.

    python -m pcdms_tpu_torch.cli.serve --model stage2 \\
        --weights_name pcdms_ckpt.pt --pretrained_model_name_or_path sd21 \\
        --port 8000

Smoke run on the CPU (no checkpoints, tiny geometry):
    python -m pcdms_tpu_torch.cli.serve --model stage2 --random_init \\
        --tiny_config --height 64 --width 64 --device cpu --port 8000

Multi-resolution deployment (one warmed engine per canvas behind a
ShapeRouter, ``serve/router.py``):
    python -m pcdms_tpu_torch.cli.serve --model stage2 --random_init \\
        --tiny_config --canvas 64 64 --canvas 64 128 --device cpu
Requests are routed by their ``vae_image`` canvas; unknown shapes get
HTTP 400. All engines share one set of modules (weights do not depend on
the resolution). ``--data_parallel`` splits each batch over every visible
card, one replica of the modules per card (``serve/stage2.py``).
"""

from __future__ import annotations

import argparse
import logging

import torch

from pcdms_tpu_torch.cli.common import setup_logging
from pcdms_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("pcdms_tpu_torch.serve.cli")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", choices=["stage2", "cascade"],
                   default="stage2")
    p.add_argument("--weights_name", type=str, default=None,
                   help="stage-2 monolithic checkpoint (.pt)")
    p.add_argument("--stage1_ckpt", type=str, default=None,
                   help="trained prior checkpoint (cascade)")
    p.add_argument("--stage3_ckpt", type=str, default=None,
                   help="trained refine checkpoint (cascade)")
    p.add_argument("--pretrained_model_name_or_path", type=str,
                   default=None, help="SD-2.1 dir (VAE weights)")
    p.add_argument("--img_width", "--width", dest="img_width", type=int,
                   default=512)
    p.add_argument("--img_height", "--height", dest="img_height", type=int,
                   default=512)
    p.add_argument("--canvas", type=int, nargs=2, action="append",
                   metavar=("H", "W"), default=None,
                   help="serve this image size (repeatable): builds one "
                        "warmed engine per canvas behind a ShapeRouter; "
                        "overrides --img_height/--img_width")
    p.add_argument("--num_inference_steps", type=int, default=20)
    p.add_argument("--guidance_scale", type=float, default=2.0)
    p.add_argument("--scheduler", type=str, default="unipc",
                   choices=["unipc", "ddim"])
    p.add_argument("--encoder_cache_interval", type=int, default=1)
    p.add_argument("--simple_variant", action="store_true")
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--data_parallel", action="store_true",
                   help="split each batch over every visible card, one "
                        "model replica per card (buckets must be multiples "
                        "of the card count)")
    p.add_argument("--max_delay_ms", type=float, default=5.0)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--no_warmup", action="store_true",
                   help="skip running every batch bucket at startup")
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--tiny_config", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def _service_configs(args, height: int):
    """Model configs and per-size service kwargs (the tiny DINOv2 token
    count depends on the served height; everything else is size-free)."""
    from pcdms_tpu_torch.models.prior_transformer import PriorConfig
    from pcdms_tpu_torch.models.unet2d import (
        stage2_unet_config, stage3_unet_config,
    )
    from pcdms_tpu_torch.models.vae import VAEConfig

    if args.tiny_config:
        from pcdms_tpu_torch.cli.common import tiny_configs
        tiny = tiny_configs()
        grid = height // tiny.dino.patch_size
        return dict(
            unet2_cfg=tiny.unet2(with_class_embed=not args.simple_variant),
            unet3_cfg=tiny.unet3, vae_cfg=tiny.vae, prior_cfg=tiny.prior,
            proj_kwargs=tiny.image_proj_kwargs,
            pose_kwargs=tiny.pose_proj_kwargs,
            dino_kw=dict(dino_tokens=grid * grid + 1,
                         dino_dim=tiny.dino.hidden_size),
            embed_dim=tiny.prior.embedding_dim, compute_dtype=torch.float32)
    return dict(
        unet2_cfg=stage2_unet_config(with_class_embed=not args.simple_variant),
        unet3_cfg=stage3_unet_config(), vae_cfg=VAEConfig(),
        prior_cfg=PriorConfig(), proj_kwargs={}, pose_kwargs={}, dino_kw={},
        embed_dim=1024, compute_dtype=torch.bfloat16)


def load_service_params(args):
    """Build (random from ``args.seed``, or loaded) every module the chosen
    flavour needs, once, on ``args.device``: stages 2 and 3 in the compute
    dtype, the prior in f32 (the cascade runs stage 1 in f32). Weights do
    not depend on the resolution, so a multi-canvas deployment
    (ShapeRouter) shares one set across its services. -> {"s2": ...,
    "s1": ..., "s3": ...} dicts of modules (s1 / s3 for the cascade)."""
    from pcdms_tpu_torch.models.prior_transformer import PriorTransformer
    from pcdms_tpu_torch.models.projections import (
        ImageProjModel, PoseCondEmbedding,
    )
    from pcdms_tpu_torch.models.unet2d import UNet2DConditionModel
    from pcdms_tpu_torch.models.vae import AutoencoderKL

    cfg = _service_configs(args, args.img_height)
    device = resolve_device(args.device)
    cascade = args.model == "cascade"
    with torch.device(device):
        if args.random_init:
            torch.manual_seed(args.seed)
            vae = AutoencoderKL(cfg["vae_cfg"])
            s2 = {"unet": UNet2DConditionModel(cfg["unet2_cfg"]),
                  "image_proj": ImageProjModel(**cfg["proj_kwargs"]),
                  "pose_proj": PoseCondEmbedding(**cfg["pose_kwargs"]),
                  "vae": vae}
            if cascade:
                s1 = {"prior": PriorTransformer(cfg["prior_cfg"])}
                s3 = {"unet": UNet2DConditionModel(cfg["unet3_cfg"]),
                      "image_proj": ImageProjModel(**cfg["proj_kwargs"]),
                      "vae": vae}
        else:
            from pcdms_tpu_torch.compat.load import (
                load_into, load_pcdms_stage2_checkpoint, load_sd_vae,
            )
            if not args.weights_name:
                raise SystemExit("--weights_name required without "
                                 "--random_init")
            if cascade and not (args.stage1_ckpt and args.stage3_ckpt):
                raise SystemExit("cascade needs --stage1_ckpt and "
                                 "--stage3_ckpt (or --random_init)")
            w2 = load_pcdms_stage2_checkpoint(args.weights_name)
            vae = load_into(AutoencoderKL(cfg["vae_cfg"]),
                            load_sd_vae(args.pretrained_model_name_or_path),
                            "vae")
            s2 = {"unet": load_into(UNet2DConditionModel(cfg["unet2_cfg"]),
                                    w2["unet"], "unet"),
                  "image_proj": load_into(
                      ImageProjModel(**cfg["proj_kwargs"]),
                      w2["image_proj"], "image_proj"),
                  "pose_proj": load_into(
                      PoseCondEmbedding(**cfg["pose_kwargs"]),
                      w2["pose_proj"], "pose_proj"),
                  "vae": vae}
            if cascade:
                from pcdms_tpu_torch.compat.load import (
                    load_pcdms_stage3_checkpoint, load_prior,
                )
                w3 = load_pcdms_stage3_checkpoint(args.stage3_ckpt)
                s1 = {"prior": load_into(PriorTransformer(cfg["prior_cfg"]),
                                         load_prior(args.stage1_ckpt),
                                         "prior")}
                s3 = {"unet": load_into(
                          UNet2DConditionModel(cfg["unet3_cfg"]),
                          w3["unet"], "unet"),
                      "image_proj": load_into(
                          ImageProjModel(**cfg["proj_kwargs"]),
                          w3["image_proj"], "image_proj"),
                      "vae": vae}
    dtype = cfg["compute_dtype"]
    params = {"s2": {k: m.to(dtype).eval() for k, m in s2.items()}}
    if cascade:
        params["s1"] = {"prior": s1["prior"].eval()}
        params["s3"] = {k: m.to(dtype).eval() for k, m in s3.items()}
    return params


def visible_devices(args) -> list:
    """``--data_parallel``'s mesh: every visible card, or the CPU."""
    device = resolve_device(args.device)
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_service(args, height=None, width=None, params=None):
    """Build one fixed-shape service. ``params`` (from
    :func:`load_service_params`) lets a router deployment share modules;
    omitted, they are built here."""
    from pcdms_tpu_torch.serve.stage2 import CascadeService, Stage2Service

    height = args.img_height if height is None else height
    width = args.img_width if width is None else width
    cfg = _service_configs(args, height)
    if params is None:
        params = load_service_params(args)
    common = dict(height=height, width=width,
                  guidance_scale=args.guidance_scale,
                  scheduler=args.scheduler,
                  compute_dtype=cfg["compute_dtype"],
                  encoder_cache_interval=args.encoder_cache_interval,
                  embed_dim=cfg["embed_dim"],
                  buckets=tuple(args.buckets),
                  max_delay_ms=args.max_delay_ms,
                  warmup=not args.no_warmup, device=args.device,
                  mesh=visible_devices(args) if args.data_parallel else None,
                  **cfg["dino_kw"])
    if args.model == "stage2":
        return Stage2Service(params["s2"],
                             num_steps=args.num_inference_steps,
                             simple_variant=args.simple_variant, **common)
    return CascadeService(params["s1"], params["s2"], params["s3"],
                          steps=args.num_inference_steps, **common)


def build_deployment(args):
    """One service, or N per-canvas services behind a ShapeRouter."""
    if not args.canvas:
        return build_service(args)
    params = load_service_params(args)
    services = [build_service(args, h, w, params=params)
                for h, w in args.canvas]
    if len(services) == 1:
        return services[0]
    from pcdms_tpu_torch.serve.router import ShapeRouter
    return ShapeRouter(services)


def main(argv=None):
    import signal
    import threading

    setup_logging()
    args = parse_args(argv)
    if args.model == "cascade" and args.simple_variant:
        raise SystemExit("--simple_variant is stage2-only")
    from pcdms_tpu_torch.serve.http import ServingServer
    service = build_deployment(args)
    server = ServingServer(service, host=args.host, port=args.port)
    sizes = args.canvas or [[args.img_height, args.img_width]]
    logger.info("model=%s canvases=%s steps=%d buckets=%s delay=%.1fms "
                "device=%s", args.model,
                ["%dx%d" % (h, w) for h, w in sizes],
                args.num_inference_steps, args.buckets, args.max_delay_ms,
                args.device)

    # graceful shutdown on SIGTERM / SIGINT: stop accepting, drain the
    # work in flight
    done = threading.Event()

    def _on_signal(signum, frame):
        logger.info("signal %d: draining and shutting down", signum)
        done.set()

    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, _on_signal)

    server.start()
    done.wait()
    server.stop()
    logger.info("served %s", service.stats())


if __name__ == "__main__":
    main()
