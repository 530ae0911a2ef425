"""Entry points for a dry run of the port, and its data-parallel worker
(counterpart of the JAX package's ``__graft_entry__.py``).

* ``entry(device=None)``: the stage-2 inpainting UNet's forward (SD-2.1's
  9-channel variant, bf16) at the batch test's shape, a 512x1024 canvas
  (64x128 latents), batch 1: returns ``(fn, example_args)``. On the
  ``meta`` device it builds without memory.
* ``dryrun_multichip(n)``: one tiny stage-2 training step with ZeRO-1 over
  a ``gloo`` world of ``n`` CPU processes, each rank's parameters held
  against the same step at a world of 1 (and, for an even ``n`` >= 4, over
  two slices of ``n / 2`` ranks).

``spawn(world, tasks, workdir)`` runs a list of task specs (``run_task``)
on every rank of such a world; the tests use it to hold the port's
data-parallel training and batch test against a world of 1 and against the
JAX package, with one spawn per world size.
"""

from __future__ import annotations

import os
import signal
from typing import Optional

import numpy as np
import torch

H, W2 = 64, 128                 # the tiny double-width canvas


def entry(device=None):
    """(fn, example_args): ``fn(unet, sample, t, ctx, class_labels,
    pose_cond)`` is the full-width stage-2 UNet's forward, bf16, batch 1."""
    from pcdms_tpu_torch.models.unet2d import (
        UNet2DConditionModel, stage2_unet_config,
    )
    from pcdms_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    with torch.device(dev):
        unet = UNet2DConditionModel(stage2_unet_config()).to(torch.bfloat16)

    def fn(unet, sample, t, ctx, class_labels, pose_cond):
        return unet(sample, t, ctx, class_labels=class_labels,
                    pose_cond=pose_cond)

    b, lh, lw, bf = 1, 64, 128, torch.bfloat16
    example_args = (
        unet,
        torch.zeros((b, lh, lw, 9), dtype=bf, device=dev),
        torch.zeros((b,), dtype=torch.long, device=dev),
        torch.zeros((b, 258, 1024), dtype=bf, device=dev),
        torch.zeros((b, 1024), dtype=bf, device=dev),
        torch.zeros((b, lh, lw, 320), dtype=bf, device=dev),
    )
    return fn, example_args


# ---------------------------------------------------------------------------
# the tiny stage-2 training set-up of the data-parallel runs
# ---------------------------------------------------------------------------

def tiny_stage2(init: Optional[str] = None, seed: int = 0,
                unet: Optional[dict] = None):
    """(trainable {unet, image_proj, pose_proj}, frozen vae) of the tiny
    stage-2 stack (``cli/common.py::tiny_configs``, ``unet`` overriding
    fields of its UNet's config) on the CPU: drawn from ``seed``, or loaded
    from ``init`` (a ``torch.save`` of {"models": {name: state dict},
    "vae": state dict})."""
    import dataclasses

    from pcdms_tpu_torch.cli.common import tiny_configs
    from pcdms_tpu_torch.models.projections import (
        ImageProjModel, PoseCondEmbedding,
    )
    from pcdms_tpu_torch.models.unet2d import UNet2DConditionModel
    from pcdms_tpu_torch.models.vae import AutoencoderKL
    tiny = tiny_configs()
    torch.manual_seed(seed)
    models = {"unet": UNet2DConditionModel(dataclasses.replace(
                  tiny.unet2(True), **(unet or {}))),
              "image_proj": ImageProjModel(**tiny.image_proj_kwargs),
              "pose_proj": PoseCondEmbedding(**tiny.pose_proj_kwargs)}
    vae = AutoencoderKL(tiny.vae)
    if init is not None:
        sd = torch.load(init, weights_only=True)
        for name, module in models.items():
            module.load_state_dict(sd["models"][name])
        vae.load_state_dict(sd["vae"])
    return models, vae.eval()


def tiny_batch(rows: int, step: int, seed: int = 0) -> dict:
    """A global stage-2 batch of ``rows`` rows at the tiny widths, from
    numpy seeded with (seed, step)."""
    rng = np.random.default_rng([seed, step])
    return {
        "st_image": rng.uniform(-1, 1, (rows, H, W2, 3)).astype(np.float32),
        "masked_image": rng.uniform(-1, 1, (rows, H, W2, 3)).astype(
            np.float32),
        "pose_image": rng.uniform(-1, 1, (rows, H, W2, 3)).astype(
            np.float32),
        "dino_features": rng.standard_normal((rows, 5, 24)).astype(
            np.float32),
        "clip_embed": rng.standard_normal((rows, 1, 16)).astype(np.float32),
    }


def _injected_loss_fn(vae, draws_path: str, counter: list, mesh):
    """The stage-2 loss with the draws of micro-step ``counter[0]`` read
    from ``draws_path`` (an ``.npz`` of the global batch's draws,
    ``<name>_<step>``), this rank's rows of them."""
    from pcdms_tpu_torch.diffusion.schedules import sd21_schedule
    from pcdms_tpu_torch.parallel.mesh import shard_batch
    from pcdms_tpu_torch.train.stage2 import stage2_loss
    table = np.load(draws_path)
    schedule = sd21_schedule()

    def loss_fn(models, batch, generator):
        step = counter[0]
        counter[0] += 1
        draws = {k: torch.from_numpy(table[f"{k}_{step}"]) for k in
                 ("vae_gt", "vae_masked", "noise", "offset", "timesteps")}
        loss = stage2_loss(models, vae, batch, shard_batch(draws, mesh),
                           schedule=schedule, noise_offset=0.0,
                           compute_dtype=torch.float32)
        return loss, {}

    return loss_fn


def optimizer_bytes(state) -> int:
    """Bytes of this rank's AdamW moments (its ZeRO-1 shard's)."""
    opt = state.optimizer.optim if state.zero1 else state.optimizer
    return sum(t.numel() * t.element_size() for s in opt.state.values()
               for t in s.values() if torch.is_tensor(t) and t.dim() > 0)


def run_task(spec: dict, mesh=None) -> dict:
    """Run one task on this rank and save its result to ``spec["out"]``
    with the rank in the name (``<out>.rank<r>.pt``); returns it.

    ``spec["kind"] == "train"``: ``run_training`` of the tiny stage-2 stack
    (``init``, ``seed``, ``unet``) on ``tiny_batch(rows, step)`` global
    batches with ``TrainConfig(**cfg)``, ``steps`` micro-steps, the port's
    draws or those of ``draws`` (an ``.npz``), checkpointing to / resuming from
    ``ckpt_dir``, and with ``sigterm`` = (rank, step) sending SIGTERM to
    that rank after that step. The result holds the trained parameters,
    the EMA, each step's loss and gradient norm (and, with ``history``, the
    parameters after each step), the bytes of this rank's optimizer state
    and the ranks of its ZeRO-1 group.
    ``spec["kind"] == "batchtest"``: ``cli/stage2_batchtest.main(argv)``.
    """
    rank = 0 if mesh is None else mesh.rank
    if spec["kind"] == "batchtest":
        from pcdms_tpu_torch.cli.stage2_batchtest import main
        result = {"written": main(spec["argv"])}
    else:
        result = _train(spec, mesh, rank)
    torch.save(result, f"{spec['out']}.rank{rank}.pt")
    return result


def _train(spec: dict, mesh, rank: int) -> dict:
    from pcdms_tpu_torch.parallel.mesh import shard_batch
    from pcdms_tpu_torch.train import checkpoint as ckpt
    from pcdms_tpu_torch.train.common import TrainConfig
    from pcdms_tpu_torch.train.loop import run_training
    from pcdms_tpu_torch.train.stage2 import stage2_loss_fn

    models, vae = tiny_stage2(spec.get("init"), spec.get("seed", 0),
                              spec.get("unet"))
    cfg = TrainConfig(**spec["cfg"])
    ckpt_dir = spec.get("ckpt_dir")
    start = 0
    if spec.get("resume") and ckpt.latest_step(ckpt_dir) is not None:
        start = ckpt.latest_step(ckpt_dir)
    if spec.get("draws"):
        loss_fn = _injected_loss_fn(vae, spec["draws"], [start], mesh)
    else:
        loss_fn = stage2_loss_fn(vae, noise_offset=0.0,
                                 compute_dtype=torch.float32, mesh=mesh)

    def batches():
        step = start
        while True:
            yield shard_batch(tiny_batch(spec["rows"], step), mesh)
            step += 1

    metrics, history = [], []

    def on_step(step, m):
        metrics.append({"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"])})
        if spec.get("history"):
            history.append({f"{k}.{n}": p.detach().clone()
                            for k, mod in models.items()
                            for n, p in mod.named_parameters()})
        if spec.get("sigterm") == (rank, step):
            os.kill(os.getpid(), signal.SIGTERM)

    state = run_training(
        loss_fn, models, batches(), cfg, mesh=mesh, device="cpu",
        seed=spec.get("seed", 0), output_dir=ckpt_dir,
        checkpointing_steps=spec.get("checkpointing_steps", 10 ** 6),
        resume_from_checkpoint=bool(spec.get("resume")),
        max_train_steps=spec["steps"], on_step=on_step, log_every=1)
    group = None
    if state.zero1:
        import torch.distributed as dist
        group = dist.get_process_group_ranks(state.optimizer.process_group)
    return {"params": {n: p.detach().clone() for n, p in state.named},
            "ema": state.ema, "metrics": metrics, "history": history,
            "step": state.step,
            "opt_bytes": optimizer_bytes(state), "zero_group": group,
            "slice_ranks": None if mesh is None else mesh.slice_ranks}


# ---------------------------------------------------------------------------
# gloo worlds of CPU processes
# ---------------------------------------------------------------------------

def _worker(rank: int, world: int, workdir: str, tasks, num_slices: int):
    import torch.distributed as dist

    from pcdms_tpu_torch.parallel.mesh import make_hybrid_mesh
    torch.set_num_threads(1)  # tiny models: one thread per rank
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=world)
    try:
        mesh = make_hybrid_mesh(num_slices, "cpu")
        for spec in tasks:
            run_task(spec, mesh)
    finally:
        dist.destroy_process_group()


def spawn(world: int, tasks, workdir: str, num_slices: int = 1,
          join: bool = True):
    """Run ``tasks`` (``run_task`` specs) in order on every rank of a
    ``gloo`` world of ``world`` CPU processes; raises if a rank fails. With
    ``join=False`` it returns at once: ``wait`` the returned context."""
    import torch.multiprocessing as mp
    os.makedirs(workdir, exist_ok=True)
    return mp.start_processes(
        _worker, args=(world, workdir, tasks, num_slices),
        nprocs=world, start_method="spawn", join=join)


def wait(context) -> None:
    """Join a ``spawn(..., join=False)`` world; raises if a rank failed."""
    while not context.join():
        pass


def load_result(out: str, rank: int = 0) -> dict:
    return torch.load(f"{out}.rank{rank}.pt", weights_only=False)


def dryrun_multichip(n_devices: int, workdir: Optional[str] = None) -> None:
    """One tiny stage-2 ZeRO-1 step over a ``gloo`` world of ``n_devices``
    CPU processes (two slices as well for an even ``n_devices`` >= 4):
    every rank must hold the same parameters, equal to the world-1 step's
    at f32 atol 1e-4 / rtol 1e-3, and a finite loss."""
    import tempfile
    rows = 2 * n_devices
    spec = {"kind": "train", "rows": rows, "steps": 1,
            "cfg": {"zero1": True, "lr_warmup_steps": 0,
                    "learning_rate": 1e-3}}
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        want = run_task(dict(spec, out=os.path.join(tmp, "world1")))
        runs = [(1, "flat")]
        if n_devices >= 4 and n_devices % 2 == 0:
            runs.append((2, "hybrid"))
        for slices, tag in runs:
            out = os.path.join(tmp, tag)
            spawn(n_devices, [dict(spec, out=out)],
                  os.path.join(tmp, f"w_{tag}"), num_slices=slices)
            first = load_result(out, 0)
            for r in range(n_devices):
                got = load_result(out, r)
                loss = got["metrics"][0]["loss"]
                assert np.isfinite(loss), f"rank {r}: loss {loss}"
                for name, p in want["params"].items():
                    # the ranks hold one replica; the world-1 step sums
                    # its gradient in another order
                    assert torch.equal(got["params"][name],
                                       first["params"][name]), (tag, r, name)
                    torch.testing.assert_close(
                        got["params"][name], p, atol=1e-4, rtol=1e-3,
                        msg=lambda m: f"{tag} rank {r} {name}: {m}")
            print(f"dryrun_multichip({n_devices}): {tag} ({slices} "
                  f"slice(s)) ok, loss={loss:.4f}")
