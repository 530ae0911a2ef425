"""The PCDMs stage-2 inpainting model: the program's modules and entry
(``pcdms_tpu_torch``: ``stage2_generate``, ``Stage2Service``), its
reference (``reference/``), its requests and its work counts.

A request (a row) is made on the device from its own seed: a [source |
black] canvas, a pose canvas, DINOv2 features and the target's CLIP
embedding; its initial latents are the serving contract's
``numpy.random.default_rng(seed)`` normals, so the sample and serve cells
draw a request the same way.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import flops, weights
from benchmark.reference import nets as ref_nets
from benchmark.reference import sampling as ref_sampling

NETS = ("unet", "vae", "image_proj", "pose_proj")


def program_modules(cfg: dict) -> dict:
    """The program's modules for ``cfg``, built on the meta device."""
    from pcdms_tpu_torch.models.projections import (
        ImageProjModel, PoseCondEmbedding,
    )
    from pcdms_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig
    from pcdms_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    u, v = cfg["unet"], cfg["vae"]
    with torch.device("meta"):
        out = {
            "unet": UNet2DConditionModel(UNetConfig(
                in_channels=u["in_channels"], out_channels=u["out_channels"],
                block_out_channels=tuple(u["block_out_channels"]),
                layers_per_block=u["layers_per_block"],
                cross_attention_dim=u["cross_attention_dim"],
                head_dim=u["attention_head_dim"],
                cross_attn_down=tuple(u["cross_attn_down"]),
                class_embed_proj_dim=u["class_embed_proj_dim"],
                norm_groups=u["norm_groups"])),
            "vae": AutoencoderKL(VAEConfig(
                in_channels=v["in_channels"],
                latent_channels=v["latent_channels"],
                block_out_channels=tuple(v["block_out_channels"]),
                layers_per_block=v["layers_per_block"],
                norm_groups=v["norm_groups"],
                scaling_factor=v["scaling_factor"])),
            "image_proj": ImageProjModel(**cfg["image_proj"]),
        }
        if "pose_proj" in cfg:
            p = cfg["pose_proj"]
            out["pose_proj"] = PoseCondEmbedding(
                out_channels=p["out_channels"],
                block_out_channels=tuple(p["block_out_channels"]))
    return out


def _reference_modules(cfg: dict, names) -> dict:
    with torch.device("meta"):
        return {k: ref_nets.NETS[k](cfg[k]) for k in names}


def draw_weights(cfg: dict, seed: int, device, names, dtypes=None) -> dict:
    """Each net's weights from ``seed``: in the compute dtype, or in
    ``dtypes[name]`` (the trainer's f32 master weights)."""
    shapes = _reference_modules(cfg, NETS if "pose_proj" in cfg
                                else NETS[:3])
    dtype = getattr(torch, cfg["compute_dtype"])
    return {k: weights.draw(weights.specs(m), weights.derive_seed(seed, i),
                            device, (dtypes or {}).get(k, dtype))
            for i, (k, m) in enumerate(shapes.items()) if k in names}


def program_models(cfg: dict, seed: int, device, names=NETS,
                   dtypes=None, trainable=()) -> dict:
    """The program's modules with the weights of ``seed``, in the compute
    dtype (or ``dtypes``) on ``device``; ``trainable`` nets require
    grad."""
    drawn = draw_weights(cfg, seed, device, names, dtypes)
    mods = program_modules(cfg)
    return {k: weights.install(mods[k], drawn[k], k in trainable)
            for k in names}


def reference_models(cfg: dict, seed: int, device, precision: str = "f32",
                     names=NETS, dtypes=None) -> dict:
    """The reference networks with the same weights, in f32."""
    drawn = draw_weights(cfg, seed, device, names, dtypes)
    mods = _reference_modules(cfg, names)
    out = {}
    for k in names:
        f32 = {n: t.float() for n, t in drawn[k].items()}
        del drawn[k]
        out[k] = ref_nets.set_precision(weights.install(mods[k], f32), precision)
    return out


def smooth_image(gen, n: int, h: int, w: int, device):
    """(n, h, w, 3) in [-1, 1]: coarse normals upsampled and squashed."""
    z = torch.randn((n, 3, h // 32, w // 32), generator=gen, device=device)
    z = F.interpolate(z, size=(h, w), mode="bilinear", align_corners=False)
    return torch.tanh(z).permute(0, 2, 3, 1).contiguous()


def pose_canvas(gen, n: int, h: int, w: int, device):
    """(n, h, w, 3): black with random bright blobs."""
    z = torch.randn((n, 1, h // 16, w // 16), generator=gen, device=device)
    z = F.interpolate(z, size=(h, w), mode="bilinear", align_corners=False)
    col = torch.rand((n, 3, 1, 1), generator=gen, device=device) * 2 - 1
    img = torch.where(z > 1.2, col, torch.full_like(col, -1.0))
    return img.expand(n, 3, h, w).permute(0, 2, 3, 1).contiguous()


def row_latents(cfg: dict, row_seed: int) -> np.ndarray:
    """The serving contract's per-request initial latents."""
    h, w = cfg["canvas"]
    return np.random.default_rng(int(row_seed)).standard_normal(
        (h // 8, w // 8, 4), dtype=np.float32)


def make_rows(cfg: dict, row_seeds, device) -> dict:
    """Stacked request inputs for ``row_seeds`` (f32 on ``device``), the
    initial latents among them."""
    h, w = cfg["canvas"]
    rows = []
    for s in row_seeds:
        gen = torch.Generator(device=device).manual_seed(int(s))
        src = smooth_image(gen, 1, h, w // 2, device)
        rows.append({
            "vae_image": torch.cat([src, -torch.ones_like(src)], dim=2),
            "st_pose": pose_canvas(gen, 1, h, w, device),
            "dino": torch.randn((1, cfg["dino_tokens"], cfg["dino_dim"]),
                                generator=gen, device=device),
            "embed": torch.randn((1, 1, cfg["embed_dim"]), generator=gen,
                                 device=device),
            "latents": torch.from_numpy(row_latents(cfg, s))[None].to(device),
        })
    return {k: torch.cat([r[k] for r in rows]) for k in rows[0]}


def generate(models: dict, rows: dict, p: dict, device):
    """The timed path: ``stage2_generate`` over a batch of rows."""
    from pcdms_tpu_torch.pipelines import stage2_inpaint
    return stage2_inpaint.stage2_generate(
        models, rows["vae_image"], rows["st_pose"], rows["dino"],
        rows["embed"], latents=rows["latents"], num_steps=p["num_steps"],
        guidance_scale=p["guidance_scale"], scheduler=p["scheduler"],
        compute_dtype=next(models["unet"].parameters()).dtype,
        deterministic_vae=True, device=device)


def reference_row(nets: dict, rows: dict, i: int, p: dict):
    """The reference's image of row ``i`` of ``rows``."""
    row = {k: v[i:i + 1].float() for k, v in rows.items()}
    with ref_sampling.full_f32():
        return ref_sampling.stage2_one(nets, row, row["latents"],
                                       p["num_steps"], p["guidance_scale"])[0]


def make_service(models: dict, cfg: dict, p: dict, device):
    from pcdms_tpu_torch.serve.stage2 import Stage2Service
    h, w = cfg["canvas"]
    return Stage2Service(
        models, height=h, width=w // 2, num_steps=p["num_steps"],
        guidance_scale=p["guidance_scale"], scheduler=p["scheduler"],
        dino_tokens=cfg["dino_tokens"], dino_dim=cfg["dino_dim"],
        embed_dim=cfg["embed_dim"], buckets=tuple(p["buckets"]),
        max_delay_ms=p["max_delay_ms"], queue_size=p["queue_size"],
        device=device)


def submit(service, rows: dict, i: int, row_seed: int):
    """Request ``i`` of the host copy ``rows`` to ``service``."""
    return service.submit(vae_image=rows["vae_image"][i],
                          st_pose=rows["st_pose"][i],
                          dino_features=rows["dino"][i],
                          embed=rows["embed"][i, 0], seed=int(row_seed))


def work(cfg: dict, n: int, p: dict) -> int:
    """Useful operations of ``n`` requests: projections, pose encoder,
    VAE encode, the CFG-doubled UNet at every step (cross-attention on the
    conditional rows), VAE decode."""
    h, w = cfg["canvas"]
    cfg_rows = 2 if p["guidance_scale"] > 1.0 else 1
    ctx = cfg["dino_tokens"] + 1
    return (flops.image_proj(cfg["image_proj"], n, cfg["dino_tokens"])
            + flops.pose_proj(cfg["pose_proj"], n, h, w)
            + flops.vae_encode(cfg["vae"], n, h, w)
            + p["num_steps"] * flops.unet(cfg["unet"], cfg_rows * n, h // 8,
                                          w // 8, ctx, cross_rows=n)
            + flops.vae_decode(cfg["vae"], n, h // 8, w // 8))


# --- the trainer ---------------------------------------------------------

TRAINED = ("unet", "image_proj", "pose_proj")
MASTER = {k: torch.float32 for k in TRAINED}


def make_train_batch(cfg: dict, row_seeds, device) -> dict:
    """A training batch (f32 on ``device``): ground-truth [source | target]
    canvases, the [source | black] masked canvases, pose canvases, DINOv2
    features and the target's CLIP embedding, one row per seed."""
    h, w = cfg["canvas"]
    rows = []
    for s in row_seeds:
        gen = torch.Generator(device=device).manual_seed(int(s))
        st = smooth_image(gen, 1, h, w, device)
        masked = st.clone()
        masked[:, :, w // 2:] = -1.0
        rows.append({
            "st_image": st, "masked_image": masked,
            "pose_image": pose_canvas(gen, 1, h, w, device),
            "dino_features": torch.randn(
                (1, cfg["dino_tokens"], cfg["dino_dim"]), generator=gen,
                device=device),
            "clip_embed": torch.randn((1, 1, cfg["embed_dim"]),
                                      generator=gen, device=device),
        })
    return {k: torch.cat([r[k] for r in rows]) for k in rows[0]}


def train_config(p: dict):
    from pcdms_tpu_torch.train.common import TrainConfig
    return TrainConfig(learning_rate=p["learning_rate"],
                       lr_scheduler=p["lr_scheduler"],
                       max_grad_norm=p["max_grad_norm"],
                       noise_offset=p["noise_offset"])


def make_trainer(cfg: dict, seed: int, p: dict, device):
    """The program's stage-2 trainer: f32 master weights of the trained
    nets, the bf16 VAE, ``stage2_loss_fn``, ``init_train_state`` and
    ``make_train_step`` (the step of ``train/loop.py::run_training``).
    Returns (models, state, step_fn, step_generator)."""
    from pcdms_tpu_torch.train.common import init_train_state, make_train_step
    from pcdms_tpu_torch.train.loop import step_generator
    from pcdms_tpu_torch.train.stage2 import stage2_loss_fn
    models = program_models(cfg, seed, device, NETS, MASTER, TRAINED)
    tc = train_config(p)
    loss_fn = stage2_loss_fn(models["vae"], noise_offset=tc.noise_offset,
                             compute_dtype=getattr(torch, cfg["compute_dtype"]))
    trained = {k: models[k] for k in TRAINED}
    return (models, init_train_state(trained, tc), make_train_step(loss_fn, tc),
            step_generator)


def step_seed(seed: int, step: int) -> int:
    """The trainer's per-step generator seed, (seed, step)."""
    return (int(seed) << 32) + int(step)


def train_draws(seed: int, step: int, batch: int, latent_hw, device) -> dict:
    """The stage-2 loss's random inputs of one step, drawn in the loss's
    order from the step's generator: two posterior noises, the noise, the
    offset shift, the timesteps."""
    gen = torch.Generator(device=device).manual_seed(step_seed(seed, step))
    shape = (batch, *latent_hw, 4)

    def normal(s):
        return torch.randn(s, generator=gen, device=device)

    d = {"vae_gt": normal(shape), "vae_masked": normal(shape),
         "noise": normal(shape)}
    d["offset"] = normal((batch, 1, 1, 4))
    d["timesteps"] = torch.randint(0, 1000, (batch,), generator=gen,
                                   device=device)
    return d


def reference_train(cfg: dict, seed: int, batches, p: dict, device,
                    precision: str = "f32", half: bool = False) -> dict:
    """The reference's first ``len(batches)`` steps: the losses, each leaf's
    first (clipped) gradient norm and each leaf's change norm after the
    last step. ``half`` is the fault that leaves out half of each batch."""
    from benchmark.reference import training as ref_train
    nets = reference_models(cfg, seed, device, precision, NETS, MASTER)
    ref_train.trainable(nets)
    names = [f"{k}.{n}" for k in TRAINED
             for n, _ in nets[k].named_parameters()]
    params = [p_ for k in TRAINED for p_ in nets[k].parameters()]
    for q in params:
        q.requires_grad_(True)
    for q in nets["vae"].parameters():
        q.requires_grad_(False)
    opt = ref_train.AdamW(params, p["learning_rate"], (0.9, 0.999), 1e-8,
                          1e-2, p["max_grad_norm"])
    h, w = cfg["canvas"]
    losses, first = [], None
    with ref_sampling.full_f32():
        for step, batch in enumerate(batches):
            n = batch["st_image"].shape[0]
            draws = train_draws(seed, step, n, (h // 8, w // 8), device)
            if half:
                batch = {k: v[:n // 2] for k, v in batch.items()}
                draws = {k: v[:n // 2] for k, v in draws.items()}
            loss = ref_train.stage2_loss(nets, nets["vae"], batch, draws,
                                         p["noise_offset"])
            grads = torch.autograd.grad(loss, params)
            clipped = opt.step(list(grads))
            losses.append(float(loss.detach()))
            if first is None:
                first = {nm: float(torch.linalg.vector_norm(g))
                         for nm, g in zip(names, clipped)}
            del grads, clipped, loss
    after = {nm: q.detach() for nm, q in zip(names, params)}
    start = draw_weights(cfg, seed, device, TRAINED, MASTER)
    delta = {f"{k}.{n}": float(torch.linalg.vector_norm(after[f"{k}.{n}"]
                                                        - t))
             for k in TRAINED for n, t in start[k].items()}
    return {"loss": losses, "grad": first, "delta": delta}


def train_work(cfg: dict, n: int) -> int:
    """Useful operations of one step over ``n`` examples: the two VAE
    encodes, and the projections, pose encoder and UNet forward and
    backward (twice the forward)."""
    h, w = cfg["canvas"]
    fwd = (flops.image_proj(cfg["image_proj"], n, cfg["dino_tokens"])
           + flops.pose_proj(cfg["pose_proj"], n, h, w)
           + flops.unet(cfg["unet"], n, h // 8, w // 8,
                        cfg["dino_tokens"] + 1))
    return 3 * fwd + 2 * flops.vae_encode(cfg["vae"], n, h, w)
