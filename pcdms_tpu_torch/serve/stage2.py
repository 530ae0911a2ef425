"""Model services: request packing for the dynamic-batching engine
(counterpart of ``pcdms_tpu/serve/stage2.py``).

They put the port's pipelines (``pipelines/stage2_inpaint.stage2_generate``,
``pipelines/cascade.cascade_generate``) behind a per-request ``submit()``.
Each service takes the modules where the JAX one takes parameter trees and
their configs: a module carries its own config. Inputs and outputs are
numpy, as in the JAX package.

Determinism contract (Stage2Service): a request's output is a pure
function of its inputs and its ``seed``, whichever other requests share its
device batch. That holds because (a) the initial latents are derived per
request from the seed on the host, (b) the VAE encodes the canvas at the
posterior mean (``deterministic_vae=True``), and (c) UniPC / eta = 0 DDIM
add no further noise. Padding rows (the engine repeats the last request to
fill a bucket) compute valid but discarded results and cannot perturb real
rows. Outputs are bit-exact within a bucket size; across bucket sizes
they agree up to floating-point rounding, since the kernels and cuBLAS
tile each batch shape differently.

CascadeService holds the same contract through all three stages: every
request carries a ``seed``, and ``cascade_generate(seeds=...)`` draws the
prior's noise per row from it (``pipelines/sampling.row_generators``,
torch streams: not the JAX package's threefry ones, so that stage is not
bitwise the JAX service's), with posterior-mean VAE encodes.

The contract needs a noise-free sampler, so both services accept only
``scheduler in {"unipc", "ddim"}`` (eta = 0 DDIM); the constructors refuse
anything else, e.g. ``lcm``, whose noise is drawn from the batch's
generator, not the request's seed.

Seeds are portable across services and across the two packages: the
stage-2 initial latents come from the request seed through numpy's Philox
stream (``_request_latents(seed)``, the JAX service's derivation), and
CascadeService passes the same latents into ``cascade_generate(
s2_latents=...)`` (stage 3 takes the ``[seed, 3]`` stream). So feeding a
cascade's predicted embedding to a Stage2Service with the same seed
reproduces the cascade's stage-2 image, up to the rounding of its batch
bucket.

``mesh=`` serves data-parallel: a list of devices that this one process
drives (``mesh=None`` is ``[device]``), one replica of the modules on each.
A device that already holds a module uses it; elsewhere the module is
copied there once, and every service of the process shares that copy.
Each bucket is split evenly over the replicas, so every bucket must be a
multiple of the device count; a request's rows never leave their replica,
and its output is what one device gives at the replica's share of the
bucket. The engine's one host thread dispatches every replica's share in
turn, and the devices run them concurrently: a host thread per replica
served fewer images/s on one H100 shared by two replicas, the threads
contending for the GIL.
"""

from __future__ import annotations

import contextlib
import copy
import weakref
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from pcdms_tpu_torch.pipelines.cascade import cascade_generate
from pcdms_tpu_torch.pipelines.stage2_inpaint import stage2_generate
from pcdms_tpu_torch.serve.engine import InferenceEngine
from pcdms_tpu_torch.utils.device import resolve_device

Models = Dict[str, torch.nn.Module]

# samplers that add no noise beyond the request-seeded initial latents: the
# only ones compatible with the per-request determinism contract
DETERMINISTIC_SCHEDULERS = ("unipc", "ddim")


def _check_scheduler(scheduler: str) -> str:
    if scheduler not in DETERMINISTIC_SCHEDULERS:
        raise ValueError(
            f"scheduler={scheduler!r} breaks the per-request determinism "
            f"contract (draws batch-shaped noise from the batch rng); "
            f"serving supports {DETERMINISTIC_SCHEDULERS}")
    return scheduler


class _DataParallel:
    """The engine's batch function over ``devices`` (the JAX service's
    ``_mesh_wrap``): ``make_batch_fn(replicas, device)`` per device, where
    ``replicas`` are ``model_sets`` on that device (``_replica``), each
    given its equal share of the bucket's rows in order; the outputs are
    joined on the first device."""

    def __init__(self, make_batch_fn: Callable, model_sets, devices,
                 buckets):
        bad = [b for b in buckets if b % len(devices)]
        if bad:
            raise ValueError(f"buckets {bad} not divisible by the mesh's "
                             f"{len(devices)} devices")
        self.devices = devices
        self.replicas = [[_replica(m, d) for m in model_sets]
                         for d in devices]
        self.fns = [make_batch_fn(r, d)
                    for r, d in zip(self.replicas, devices)]

    def __call__(self, batch):
        per = len(next(iter(batch.values()))) // len(self.fns)
        outs = []
        for i, (fn, dev) in enumerate(zip(self.fns, self.devices)):
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                outs.append(fn({k: v[i * per:(i + 1) * per]
                                for k, v in batch.items()}))
        if len(outs) == 1:
            return outs[0]
        first = self.devices[0]
        if isinstance(outs[0], dict):
            return {k: torch.cat([o[k].to(first) for o in outs])
                    for k in outs[0]}
        return torch.cat([o.to(first) for o in outs])


# module -> {device: its copy there}, shared by every service of the process
_COPIES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _replica(models: Optional[Models], device) -> Optional[Models]:
    """``models`` on ``device``: each module itself where it is there
    already, else its one copy there (made on first use; serving never
    changes a module's weights)."""
    if models is None:
        return None

    def on(m):
        p = next(iter(m.state_dict().values()), None)
        if p is None or (p.device.type == device.type and (
                device.index is None or p.device.index == device.index)):
            return m
        copies = _COPIES.setdefault(m, {})
        if str(device) not in copies:
            copies[str(device)] = copy.deepcopy(m).to(device)
        return copies[str(device)]

    return {k: on(m) for k, m in models.items()}


def _request_latents(seed: int, lh: int, lw: int,
                     stage: int = 2) -> np.ndarray:
    """Per-request initial noise from the request seed (host-side numpy
    Philox: stable across processes and packages, independent of
    batching). Stage 2 is the plain ``default_rng(seed)`` stream, other
    stages the ``[seed, stage]`` substream; the JAX service draws the
    same."""
    rng = (np.random.default_rng(int(seed)) if stage == 2
           else np.random.default_rng([int(seed), int(stage)]))
    return rng.standard_normal((lh, lw, 4), dtype=np.float32)


def _check(name, arr, shape):
    arr = np.asarray(arr, np.float32)
    if arr.shape != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {arr.shape}")
    return arr


class Stage2Service:
    """Dynamic-batched stage-2 pose-transfer serving.

    One request = (source canvas, pose canvas, DINOv2 features, optional
    prior embedding, seed) -> the generated (H, 2W, 3) canvas in [-1, 1]
    (the right half is the synthesized target). ``models``: {"unet",
    "image_proj", "pose_proj", "vae"}, used as they are when already in
    ``compute_dtype`` on ``device`` (None: CUDA). Results are per-request
    deterministic regardless of batch composition (module docstring).
    """

    def __init__(self, models: Models, *,
                 height: int = 512, width: int = 512,
                 num_steps: int = 20,
                 guidance_scale: float = 2.0,
                 scheduler: str = "unipc",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 encoder_cache_interval: int = 1,
                 simple_variant: bool = False,
                 dino_tokens: int = 257, dino_dim: int = 1536,
                 embed_dim: int = 1024,
                 buckets: Sequence[int] = (1, 2, 4, 8),
                 max_delay_ms: float = 5.0,
                 queue_size: int = 256,
                 mesh=None,
                 warmup: bool = False,
                 device=None):
        scheduler = _check_scheduler(scheduler)
        devices = [resolve_device(d) for d in (mesh or [device])]
        self.height, self.width = height, width
        self.lh, self.lw = height // 8, (2 * width) // 8
        self.simple_variant = simple_variant
        self._dino_shape = (dino_tokens, dino_dim)
        self._embed_dim = embed_dim
        self._models = models

        def make_batch_fn(replicas, d):
            replica, = replicas

            def batch_fn(batch):
                embed = None if simple_variant else batch["embed"][:, None, :]
                return stage2_generate(
                    replica, batch["vae_image"], batch["st_pose"],
                    batch["dino"], embed, latents=batch["latents"],
                    num_steps=num_steps, guidance_scale=guidance_scale,
                    scheduler=scheduler, num_samples=1,
                    compute_dtype=compute_dtype,
                    encoder_cache_interval=encoder_cache_interval,
                    deterministic_vae=True, device=d)

            return batch_fn

        self._dp = _DataParallel(make_batch_fn, [models], devices, buckets)
        self.engine = InferenceEngine(
            self._dp, buckets=buckets, max_delay_ms=max_delay_ms,
            queue_size=queue_size, name="stage2")
        if warmup:
            self.engine.warmup(self._example())

    def _example(self):
        ex = {
            "vae_image": np.zeros((self.height, 2 * self.width, 3),
                                  np.float32),
            "st_pose": np.zeros((self.height, 2 * self.width, 3),
                                np.float32),
            "dino": np.zeros(self._dino_shape, np.float32),
            "latents": _request_latents(0, self.lh, self.lw),
        }
        if not self.simple_variant:
            ex["embed"] = np.zeros((self._embed_dim,), np.float32)
        return ex

    def submit(self, *, vae_image, st_pose, dino_features,
               embed: Optional[np.ndarray] = None, seed: int = 0,
               timeout: Optional[float] = None):
        """Enqueue one request; returns a Future of the (H, 2W, 3) image."""
        h, w2 = self.height, 2 * self.width
        inputs = {
            "vae_image": _check("vae_image", vae_image, (h, w2, 3)),
            "st_pose": _check("st_pose", st_pose, (h, w2, 3)),
            "dino": _check("dino_features", dino_features,
                           self._dino_shape),
            "latents": _request_latents(seed, self.lh, self.lw),
        }
        if self.simple_variant:
            if embed is not None:
                raise ValueError("simple_variant service takes no prior "
                                 "embedding")
        else:
            if embed is None:
                raise ValueError(
                    f"embed ({self._embed_dim},) required: stage-1 "
                    "prediction or GT CLIP embedding")
            inputs["embed"] = _check("embed", np.ravel(embed),
                                     (self._embed_dim,))
        return self.engine.submit(inputs, timeout=timeout)

    def stats(self) -> dict:
        return self.engine.stats()

    def close(self, drain: bool = True):
        self.engine.close(drain=drain)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class CascadeService:
    """Dynamic-batched three-stage cascade serving.

    One request = (source CLIP embedding, source / target keypoints,
    canvases, DINOv2 features, seed) -> {"refined": (H, W, 3),
    "inpainted": (H, 2W, 3), "embeds": (E,)}. ``stage1_models``:
    {"prior"}; ``stage2_models``: {"unet", "image_proj", "pose_proj",
    "vae"}; ``stage3_models``: {"unet", "image_proj", "vae"}. Per-request
    deterministic regardless of batch composition (module docstring).
    """

    def __init__(self, stage1_models: Models, stage2_models: Models,
                 stage3_models: Models, *,
                 height: int = 512, width: int = 512,
                 steps: int = 20, guidance_scale: float = 2.0,
                 scheduler: str = "unipc",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 encoder_cache_interval: int = 1,
                 dino_tokens: int = 257, dino_dim: int = 1536,
                 embed_dim: int = 1024,
                 buckets: Sequence[int] = (1, 2, 4, 8),
                 max_delay_ms: float = 5.0,
                 queue_size: int = 256,
                 mesh=None,
                 warmup: bool = False,
                 device=None):
        scheduler = _check_scheduler(scheduler)
        devices = [resolve_device(d) for d in (mesh or [device])]
        self.height, self.width = height, width
        self._dino_shape = (dino_tokens, dino_dim)
        self._embed_dim = embed_dim
        lh, lw2 = height // 8, (2 * width) // 8

        def make_batch_fn(replicas, d):
            s1, s2, s3 = replicas

            def batch_fn(batch):
                # host-Philox initial latents from the per-row seeds: the
                # same derivation as Stage2Service's, so seeds are portable
                seeds = np.asarray(batch["seed"]).reshape(-1)
                s2_lat = np.stack(
                    [_request_latents(s, lh, lw2) for s in seeds])
                s3_lat = np.stack([_request_latents(s, lh, lw2 // 2, stage=3)
                                   for s in seeds])
                return cascade_generate(
                    s1, s2, s3,
                    batch["s_embed"], batch["s_pose"], batch["t_pose"],
                    batch["vae_image"], batch["st_pose"], batch["dino"],
                    seeds=seeds, s2_latents=s2_lat, s3_latents=s3_lat,
                    prior_steps=steps, inpaint_steps=steps,
                    refine_steps=steps, guidance_scale=guidance_scale,
                    scheduler=scheduler, compute_dtype=compute_dtype,
                    encoder_cache_interval=encoder_cache_interval, device=d)

            return batch_fn

        self._dp = _DataParallel(
            make_batch_fn, [stage1_models, stage2_models, stage3_models],
            devices, buckets)
        self.engine = InferenceEngine(
            self._dp, buckets=buckets, max_delay_ms=max_delay_ms,
            queue_size=queue_size, name="cascade")
        if warmup:
            self.engine.warmup(self._example())

    def _example(self):
        h, w2 = self.height, 2 * self.width
        return {
            "s_embed": np.zeros((self._embed_dim,), np.float32),
            "s_pose": np.zeros((36,), np.float32),
            "t_pose": np.zeros((36,), np.float32),
            "vae_image": np.zeros((h, w2, 3), np.float32),
            "st_pose": np.zeros((h, w2, 3), np.float32),
            "dino": np.zeros(self._dino_shape, np.float32),
            "seed": np.int32(0),
        }

    def submit(self, *, s_embed, s_pose, t_pose, vae_image, st_pose,
               dino_features, seed: int = 0,
               timeout: Optional[float] = None):
        h, w2 = self.height, 2 * self.width
        inputs = {
            "s_embed": _check("s_embed", np.ravel(s_embed),
                              (self._embed_dim,)),
            "s_pose": _check("s_pose", np.ravel(s_pose), (36,)),
            "t_pose": _check("t_pose", np.ravel(t_pose), (36,)),
            "vae_image": _check("vae_image", vae_image, (h, w2, 3)),
            "st_pose": _check("st_pose", st_pose, (h, w2, 3)),
            "dino": _check("dino_features", dino_features,
                           self._dino_shape),
            "seed": np.asarray(seed, np.int32),
        }
        return self.engine.submit(inputs, timeout=timeout)

    def stats(self) -> dict:
        return self.engine.stats()

    def close(self, drain: bool = True):
        self.engine.close(drain=drain)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
