"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. build the CUDA kernels from ``pcdms_tpu_torch/ops/csrc`` with nvcc;
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (bf16, with f32 spot checks), and time the kernel,
     the plain version, and ``scaled_dot_product_attention`` as a yardstick;
  3. one full-width stage-2 UNet forward (512x1024 canvas, one pair,
     CFG-doubled to 2, bf16, random weights) with the kernels and with plain
     attention, compared by the relative L2 error of eps;
  4. the main path: ``stage2_generate`` at full width (DDIM 4 steps and
     UniPC 3 steps at default routing, then DDIM 2 steps under
     PCDMS_FROZEN_MAX=0 PCDMS_SHORTKV=pallas), with decode. Launch counters
     are reset just before each run and read just after it.

The last three lines are the card's name and power limit (nvidia-smi), a
JSON object with one record per kernel, and ``{"ok": true, "device": ...}``.
Any failed check exits non-zero before the result lines. The script needs
CUDA and the repository beside it; it imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
SEED = 0
# (B*H, Lq, Lk) of the UNet self-attention at a 512x1024 canvas, one pair
# CFG-doubled: 64x128, 32x64 and 16x32 latent tokens with 5 / 10 / 20 heads
PATH_SHAPES = [(10, 8192, 8192), (20, 2048, 2048), (40, 512, 512)]
# the 258-token cross-attention at the same levels (short-kv kernel)
SHORTKV_SHAPES = [(10, 8192, 258), (20, 2048, 258), (40, 512, 258)]
# kernel vs plain version. f32 outputs: max abs error <= 2e-5. bf16 outputs
# (and the bf16-softmax variant): max abs error <= 1e-2 * max|plain|. The
# two round the same f32 sum to bf16 after a different accumulation order,
# so they may differ by one bf16 ulp, at most 2^-7 = 7.8e-3 of the value;
# 1e-2 admits that at any magnitude. An absolute bar would not scale with
# the output: at L = 8192 its RMS is about sqrt(e / L) = 0.018, and a kernel
# that dropped one 64-key tile there would be off by about 0.01.
BAR_REL, BAR_F32 = 1e-2, 2e-5
# relative L2 of the full-width UNet eps, kernels vs plain attention. Both
# run the same bf16 network; they differ only in where the attention
# weights are rounded to bf16 (the frozen kernel rounds exp2(s - m0) with
# m0 = rowmax + 24, the plain path rounds softmax(s)), about 2^-9 relative
# per weight, carried through 15 attention layers and bf16 activations:
# expected around 1e-2, so 5e-2 leaves headroom and still catches a kernel
# that is wrong on any one layer.
BAR_UNET_REL_L2 = 5e-2

SOURCE = "pcdms_tpu_torch/ops/csrc/flash_attention.cu"
KERNELS = {
    "flash_frozen": "pcdms_tpu/ops/flash_attention.py:154",
    "flash_online": "pcdms_tpu/ops/flash_attention.py:71",
    "flash_shortkv": "pcdms_tpu/ops/flash_attention.py:316",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bh: int, lq: int, lk: int, d: int = 64, itemsize: int = 2):
    """Least time for the function on an H100 SXM: bytes (q, k, v read
    once, o written once) over HBM rate vs bf16 flops over the tensor-core
    peak. Returns (ms, 'bytes' | 'operations')."""
    nbytes = (2 * bh * lq * d + 2 * bh * lk * d) * itemsize
    flops = 4 * bh * lq * lk * d
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def phase_build():
    from pcdms_tpu_torch.ops import _build
    seconds = _build.build()
    print(f"[build] flash_attention.cu: {seconds:.1f} s (nvcc, sm_90a)")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")


def phase_kernels(fa):
    """Each kernel vs its plain version; returns per-kernel records at the
    level-0 shape for the JSON line."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    records = {}

    def inputs(bh, lq, lk, dtype):
        return [torch.randn((bh, n, 64), generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
                for n in (lq, lk, lk)]

    def check(name, kernel, plain, bh, lq, lk, dtype, timed,
              bf16_softmax=False):
        q, k, v = inputs(bh, lq, lk, dtype)
        scale = 1.0 / math.sqrt(64)
        got = kernel(q, k, v, scale)
        want = plain(q, k, v, scale)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        amax = want.float().abs().max().item()
        rms = want.float().square().mean().sqrt().item()
        finite = bool(torch.isfinite(got).all())
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        if dtype == torch.bfloat16 or bf16_softmax:
            bar = BAR_REL * amax
            bar_text = f"{BAR_REL:g} x max|want| {amax:.3e}"
        else:
            bar, bar_text = BAR_F32, "f32"
        line = (f"[kernel] {name} {tag} bh={bh} lq={lq} lk={lk}: "
                f"max_abs_err={err:.3e} (bar {bar:.3e} = {bar_text}; "
                f"rms|want| {rms:.3e})")
        rec = None
        if timed:
            ms = cuda_ms(lambda: kernel(q, k, v, scale), 10)
            plain_ms = cuda_ms(lambda: plain(q, k, v, scale), 3, 1)
            q4, k4, v4 = q[None], k[None], v[None]
            lib_ms = cuda_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(q4, k4, v4), 10)
            b_ms, b_by = bound_ms(bh, lq, lk)
            line += (f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                     f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} "
                     f"({b_by})")
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        print(line, flush=True)
        if not finite or not err <= bar:
            fail(f"{name} disagrees with its plain version: {line}")
        return rec

    bf16, f32 = torch.bfloat16, torch.float32
    variants = [
        ("flash_frozen", fa.flash_frozen, fa.flash_frozen_plain,
         PATH_SHAPES + [(10, 640, 600)]),
        ("flash_online", fa.flash_online, fa.flash_online_plain,
         PATH_SHAPES + [(10, 640, 600)]),
        ("flash_shortkv", fa.shortkv_attention, fa.shortkv_plain,
         SHORTKV_SHAPES + [(10, 300, 100)]),
    ]
    for name, kernel, plain, shapes in variants:
        for i, (bh, lq, lk) in enumerate(shapes):
            rec = check(name, kernel, plain, bh, lq, lk, bf16,
                        timed=lk != 600 and lk != 100)
            if i == 0:
                records[name] = rec
        bh, lq, lk = (2, 640, 258) if name == "flash_shortkv" else (2, 640,
                                                                     600)
        check(name, kernel, plain, bh, lq, lk, f32, False)
    ob = (lambda q, k, v, s: fa.flash_online(q, k, v, s, True),
          lambda q, k, v, s: fa.flash_online_plain(q, k, v, s, True))
    check("flash_online[exp_bf16]", *ob, 10, 2048, 2048, bf16, False, True)
    check("flash_online[exp_bf16]", *ob, 2, 640, 600, f32, False, True)
    return records


def build_models(dev, with_class_embed=True):
    from pcdms_tpu_torch.models.projections import (
        ImageProjModel, PoseCondEmbedding,
    )
    from pcdms_tpu_torch.models.unet2d import (
        UNet2DConditionModel, stage2_unet_config,
    )
    from pcdms_tpu_torch.models.vae import AutoencoderKL
    torch.manual_seed(SEED)
    with torch.device(dev):
        models = {
            "unet": UNet2DConditionModel(stage2_unet_config(with_class_embed)),
            "vae": AutoencoderKL(),
            "image_proj": ImageProjModel(),
            "pose_proj": PoseCondEmbedding(),
        }
        # the zero-initialised pose conv_out would hide the pose path
        torch.nn.init.normal_(models["pose_proj"].conv_out.weight, std=0.02)
    return {k: m.to(torch.bfloat16).eval() for k, m in models.items()}


def phase_unet(fa, models, dev):
    unet = models["unet"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    sample, pose = rand(2, 64, 128, 9), rand(2, 64, 128, 320)
    ctx, labels = rand(2, 258, 1024), rand(2, 1024)
    ctx[:1] = 0
    labels[:1] = 0
    ts = torch.tensor([500, 500], device=dev)
    with torch.inference_mode():
        fa.reset_launches()
        eps_k = unet(sample, ts, ctx, labels, pose, zero_ctx_prefix=1)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        unet.cfg = dataclasses.replace(unet.cfg, use_flash=False)
        try:
            eps_p = unet(sample, ts, ctx, labels, pose, zero_ctx_prefix=1)
        finally:
            unet.cfg = dataclasses.replace(unet.cfg, use_flash=True)
        fwd_ms = cuda_ms(lambda: unet(sample, ts, ctx, labels, pose,
                                      zero_ctx_prefix=1), 3, 1)
    rel = ((eps_k.float() - eps_p.float()).norm()
           / eps_p.float().norm()).item()
    print(f"[unet] stage2 UNet 512x1024 batch 2 bf16: eps rel_l2 kernels vs "
          f"plain = {rel:.3e} (bar {BAR_UNET_REL_L2:g}); launches {launches};"
          f" forward_ms={fwd_ms:.2f}", flush=True)
    if not torch.isfinite(eps_k).all() or not rel <= BAR_UNET_REL_L2:
        fail("full-width UNet eps: kernels disagree with plain attention")
    if launches["flash_frozen"] != 15 or sum(launches.values()) != 15:
        fail(f"expected 15 frozen-kernel launches per UNet forward, got "
             f"{launches}")


def phase_pipeline(fa, models, dev):
    from pcdms_tpu_torch.pipelines.stage2_inpaint import stage2_generate
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    canvas = torch.rand((1, 512, 1024, 3), generator=gen, device=dev) * 2 - 1
    canvas[:, :, 512:] = -1.0
    pose = torch.rand((1, 512, 1024, 3), generator=gen, device=dev) * 2 - 1
    dino = torch.randn((1, 257, 1536), generator=gen, device=dev)
    emb = torch.randn((1, 1, 1024), generator=gen, device=dev)

    unet_ms = []

    def pre(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        unet_ms.append([ev])

    def post(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        unet_ms[-1].append(ev)

    hooks = [models["unet"].register_forward_pre_hook(pre),
             models["unet"].register_forward_hook(post)]
    launches = {}
    runs = [("ddim", 4, {}), ("unipc", 3, {}),
            ("ddim", 2, {"PCDMS_FROZEN_MAX": "0", "PCDMS_SHORTKV": "pallas"})]
    try:
        for scheduler, steps, env in runs:
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            unet_ms.clear()
            torch.cuda.reset_peak_memory_stats()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fa.reset_launches()
                images = stage2_generate(
                    models, canvas, pose, dino, emb,
                    generator=torch.Generator(device=dev).manual_seed(SEED),
                    num_steps=steps, scheduler=scheduler, guidance_scale=2.0,
                    compute_dtype=torch.bfloat16, decode=True)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = dict(fa.LAUNCHES)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            step_s = sum(a.elapsed_time(b) for a, b in unet_ms) / 1e3 / steps
            peak = torch.cuda.max_memory_allocated() / 2**30
            ok = (tuple(images.shape) == (1, 512, 1024, 3)
                  and bool(torch.isfinite(images).all())
                  and images.abs().max().item() < 1e3)
            label = f"{scheduler}-{steps}" + (
                "[" + " ".join(f"{k}={v}" for k, v in env.items()) + "]"
                if env else "")
            print(f"[pipeline] stage2_generate {label} 512x1024 1 pair CFG "
                  f"2.0 bf16: {seconds:.2f} s total, {step_s:.4f} s per "
                  f"denoise step (UNet, CUDA events), peak "
                  f"{peak:.2f} GiB, images min {images.min().item():.3f} "
                  f"max {images.max().item():.3f}, launches {counts}",
                  flush=True)
            if not ok:
                fail(f"stage2_generate {label}: images not finite / "
                     f"out of range, shape {tuple(images.shape)}")
            if not env and counts["flash_frozen"] != 15 * steps:
                fail(f"{label}: expected {15 * steps} frozen launches, "
                     f"got {counts}")
            for name, c in counts.items():
                if c:
                    launches.setdefault(name, c)
    finally:
        for h in hooks:
            h.remove()
    for name in KERNELS:
        if not launches.get(name):
            fail(f"kernel {name} was not launched on the main path")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from pcdms_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {name}; TF32 off for matmul and cuDNN (reference side)",
          flush=True)
    t0 = time.perf_counter()
    phase_build()
    records = phase_kernels(fa)
    models = build_models(dev)
    phase_unet(fa, models, dev)
    launches = phase_pipeline(fa, models, dev)
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=SOURCE, replaces=KERNELS[k],
             launches=launches[k], **records[k]) for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
