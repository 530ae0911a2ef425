"""The fused GroupNorm + SiLU + conv3x3 (kernel 7) on the CPU: the port's
plain version (what the CUDA kernel is held against on the card) against the
JAX package's Pallas kernel in interpret mode, in every mode, at the JAX
suite's shape and at one with Cin != Cout inside JAX's Pallas domain (f32 at
atol 1e-4 / rtol 1e-3; bf16 at 1e-2 of the largest magnitude, one bf16 ulp
after a different accumulation order); ``gn_affine_coeffs``; and a tiny
UNet and ``stage2_generate`` with ``fused_conv=True`` against JAX's (its
XLA fallback on the CPU, the same function). The port is NCHW with torch
(Cout, Cin, 3, 3) weights, JAX NHWC with HWIO: the inputs are transposed.

Also the CPU side of the bf16 CUDA kernel: its block plan (``conv_plan``:
every output covered once, the 9 * Cin reduction once over the split-K
blocks, shared memory within an H100's), the constants it mirrors, a
static check that the source is the Hopper design, and the re-laid weight
kept per weight version."""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdms_tpu.models.unet2d import unet_apply
from pcdms_tpu.ops.fused_conv import (
    _pick_co_block, fits_fused_conv, gn_affine_coeffs as j_coeffs,
    gn_silu_conv3x3 as j_gn_silu_conv3x3,
)
from pcdms_tpu.pipelines.stage2_inpaint import stage2_generate as j_generate

from pcdms_tpu_torch.ops import fused_conv as fc
from pcdms_tpu_torch.ops.fused_conv import (
    fused_gn_silu_conv, fused_gn_silu_conv_plain, gn_affine_coeffs,
    gn_silu_conv3x3,
)
from pcdms_tpu_torch.pipelines.stage2_inpaint import stage2_generate

from _torch_common import (
    TINY, TOL, image_proj_pair, n, pose_proj_pair, t, unet_pair, vae_pair,
)

# (B, H, W, Cin, Cout, groups): tests/test_fused_conv.py's shape, and one
# with Cin != Cout that JAX still runs through its Pallas kernel
SHAPES = [(2, 8, 16, 128, 128, 4), (2, 8, 16, 64, 128, 8)]
MODES = ["none", "temb", "residual", "no_act"]


def _case(shape, seed=0):
    b, h, w, cin, cout, groups = shape
    assert fits_fused_conv(h, w, cin) and _pick_co_block(cin, cout) > 0
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.standard_normal((b, h, w, cin)).astype(f) * 2 + 0.5,
        scale=(1 + 0.1 * rng.standard_normal(cin)).astype(f),
        shift=(0.1 * rng.standard_normal(cin)).astype(f),
        kernel=(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)
                ).astype(f),
        bias=(0.1 * rng.standard_normal(cout)).astype(f),
        temb=rng.standard_normal((b, cout)).astype(f),
        residual=rng.standard_normal((b, h, w, cout)).astype(f),
        groups=groups)


def _extra(c, mode):
    return dict(temb=c["temb"] if mode == "temb" else None,
                residual=c["residual"] if mode == "residual" else None,
                apply_act=mode != "no_act")


def _nchw(a):
    return None if a is None else t(np.ascontiguousarray(a.transpose(0, 3, 1,
                                                                     2)))


def _port(c, mode, dtype=torch.float32):
    e = _extra(c, mode)
    y = gn_silu_conv3x3(
        _nchw(c["x"]).to(dtype), t(c["scale"]), t(c["shift"]),
        t(c["kernel"].transpose(3, 2, 0, 1).copy()), t(c["bias"]),
        num_groups=c["groups"],
        temb=None if e["temb"] is None else t(e["temb"]),
        residual=_nchw(e["residual"]), apply_act=e["apply_act"])
    assert y.dtype == dtype
    return n(y).transpose(0, 2, 3, 1)


def _jax(c, mode, dtype=jnp.float32):
    e = _extra(c, mode)
    return n(j_gn_silu_conv3x3(
        jnp.asarray(c["x"], dtype), c["scale"], c["shift"],
        jnp.asarray(c["kernel"]), c["bias"], num_groups=c["groups"],
        temb=e["temb"], residual=e["residual"], apply_act=e["apply_act"],
        interpret=True))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_pallas_interpret(shape, mode):
    c = _case(shape)
    np.testing.assert_allclose(_port(c, mode), _jax(c, mode), **TOL)


@pytest.mark.parametrize("mode", ["temb", "residual"])
def test_bf16_matches_pallas_interpret(mode):
    c = _case(SHAPES[0], seed=1)
    got = _port(c, mode, torch.bfloat16)
    want = _jax(c, mode, jnp.bfloat16)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_gn_affine_coeffs_match_jax():
    c = _case(SHAPES[1])
    a, cc = gn_affine_coeffs(_nchw(c["x"]), t(c["scale"]), t(c["shift"]),
                             c["groups"], 1e-5)
    ja, jc = j_coeffs(c["x"], c["scale"], c["shift"], c["groups"], 1e-5)
    np.testing.assert_allclose(n(a), n(ja), **TOL)
    np.testing.assert_allclose(n(cc), n(jc), **TOL)


def test_cpu_wrapper_is_the_plain_version_and_differentiable():
    """On the CPU the wrapper takes the plain version, which autograd
    differentiates (as JAX's XLA fallback); both extras at once raise."""
    c = _case((1, 4, 6, 8, 16, 2))
    x = _nchw(c["x"]).requires_grad_()
    a, cc = torch.rand(1, 8) + 0.5, torch.randn(1, 8)
    w = t(c["kernel"].transpose(3, 2, 0, 1).copy()).requires_grad_()
    bias = t(c["bias"])
    y = fused_gn_silu_conv(x, a, cc, w, bias)
    assert torch.equal(y, fused_gn_silu_conv_plain(x, a, cc, w, bias))
    y.square().sum().backward()
    assert x.grad is not None and w.grad is not None
    with pytest.raises(ValueError):
        fused_gn_silu_conv(x, a, cc, w, bias, temb=torch.zeros(1, 16),
                           residual=torch.zeros(1, 16, 4, 6))


def _unet_inputs(b=4):
    rng = np.random.default_rng(8)
    sample = rng.standard_normal((b, 16, 32, 9)).astype(np.float32)
    ts = np.array([999, 500, 1, 250], np.int32)[:b]
    ctx = rng.standard_normal((b, 6, 16)).astype(np.float32)
    ctx[:2] = 0.0
    pose = rng.standard_normal((b, 16, 32, 8)).astype(np.float32)
    labels = rng.standard_normal((b, 16)).astype(np.float32)
    return sample, ts, ctx, pose, labels


def _fused_cfg(with_class_embed=True):
    return dataclasses.replace(TINY.unet2(with_class_embed), fused_conv=True)


def test_fused_unet_matches_jax():
    cfg = _fused_cfg()
    params, model = unet_pair(cfg, 41)
    assert model.cfg.fused_conv
    sample, ts, ctx, pose, labels = _unet_inputs()
    want = jax.jit(unet_apply, static_argnums=1,
                   static_argnames="zero_ctx_prefix")(
        params, cfg, sample, ts, ctx, class_labels=labels, pose_cond=pose,
        zero_ctx_prefix=2)
    with torch.no_grad():
        got = model(t(sample), t(ts), t(ctx), class_labels=t(labels),
                    pose_cond=t(pose), zero_ctx_prefix=2)
        # the same weights on the unfused route: the same function
        model.cfg = dataclasses.replace(model.cfg, fused_conv=False)
        unfused = model(t(sample), t(ts), t(ctx), class_labels=t(labels),
                        pose_cond=t(pose), zero_ctx_prefix=2)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    np.testing.assert_allclose(n(got), n(unfused), **TOL)


@pytest.mark.parametrize("scheduler", ["ddim", "unipc"])
def test_stage2_generate_fused_matches_jax(scheduler):
    cfg = _fused_cfg()
    ju, tu = unet_pair(cfg, 42)
    jv, tv = vae_pair(TINY.vae, 43)
    ji, ti = image_proj_pair(44, **TINY.image_proj_kwargs)
    jp, tp = pose_proj_pair(45, **TINY.pose_proj_kwargs)
    rng = np.random.default_rng(46)
    canvas = rng.uniform(-1, 1, (1, 64, 128, 3)).astype(np.float32)
    canvas[:, :, 64:] = -1.0
    pose = rng.uniform(-1, 1, (1, 64, 128, 3)).astype(np.float32)
    dino = rng.standard_normal((1, 257, 24)).astype(np.float32)
    emb = rng.standard_normal((1, 1, 16)).astype(np.float32)
    latents = rng.standard_normal((2, 8, 16, 4)).astype(np.float32)
    kw = dict(num_steps=3, scheduler=scheduler, num_samples=2,
              guidance_scale=2.0, deterministic_vae=True, decode=True,
              eta=0.0)
    want = j_generate({"unet": ju, "vae": jv, "image_proj": ji,
                       "pose_proj": jp}, canvas, pose, dino, emb,
                      jax.random.PRNGKey(0), latents, unet_cfg=cfg,
                      vae_cfg=TINY.vae, compute_dtype=jnp.float32, **kw)
    got = stage2_generate({"unet": tu, "vae": tv, "image_proj": ti,
                           "pose_proj": tp}, canvas, pose, dino, emb,
                          latents=latents, compute_dtype=torch.float32,
                          device="cpu", **kw)
    assert got.shape == (2, 64, 128, 3)
    np.testing.assert_allclose(n(got), n(want), **TOL)


# ---------------------------------------------------------------------------
# the bf16 CUDA kernel's plan and source, as far as the CPU reaches them
# ---------------------------------------------------------------------------

_CSRC = Path(fc.__file__).resolve().parent / "csrc"
# (B, H, W, Cin, Cout): the 14 resnet convs of the full-width stage-2 UNet
# at batch 2 (chip_smoke.CONV_SHAPES), level 0 at the batch test's UNet
# batch 16, and shapes the card tests run: ragged, split-K, Cin not a
# multiple of 64, W not a multiple of 8 or 16, smaller than a tile
UNET_CONVS = [(64, 128, 320, 320), (64, 128, 640, 320), (64, 128, 960, 320),
              (32, 64, 320, 640), (32, 64, 640, 640), (32, 64, 960, 640),
              (32, 64, 1280, 640), (32, 64, 1920, 640),
              (16, 32, 640, 1280), (16, 32, 1280, 1280),
              (16, 32, 1920, 1280), (16, 32, 2560, 1280),
              (8, 16, 1280, 1280), (8, 16, 2560, 1280)]
PLAN_SHAPES = ([(2, *s) for s in UNET_CONVS] + [(16, 64, 128, 320, 320)]
               + [(3, 7, 9, 40, 24), (1, 16, 32, 320, 200),
                  (2, 8, 16, 64, 128), (3, 5, 20, 200, 320),
                  (1, 3, 5, 64, 160), (1, 20, 40, 200, 200),
                  (1, 8, 16, 1280, 1280), (1, 1, 1, 8, 8)])


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_conv_plan_covers_every_output_once(shape):
    """Blocks (tile, N block, image) cover each output (image, channel,
    pixel) exactly once, for every split-K block alike."""
    b, h, w, cin, cout = shape
    plan = fc.conv_plan(b, cin, cout, h, w)
    th, tw = plan["tile"]
    tiles, n_blocks, gz = plan["grid"]
    assert tiles == plan["tiles_h"] * plan["tiles_w"]
    assert gz == b * plan["split"] and n_blocks == plan["n_blocks"]
    assert th * tw == 128 and tw == 16
    for z in range(plan["split"]):
        cover = np.zeros((b, cout, h, w), np.int32)
        for img in range(b):
            for tile in range(tiles):
                ty, tx = divmod(tile, plan["tiles_w"])
                for nb in range(n_blocks):
                    n0 = nb * plan["block_n"]
                    cover[img, n0:n0 + plan["block_n"],
                          ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw] += 1
        assert (cover == 1).all(), z
    # no block lies wholly outside the output
    assert (plan["tiles_h"] - 1) * th < h and (plan["tiles_w"] - 1) * tw < w
    assert (n_blocks - 1) * plan["block_n"] < cout


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_conv_plan_split_covers_the_reduction_once(shape, sms):
    """The split-K blocks of an output tile share its chunks out, each of
    the 9 taps with each, so that 9 * Cin products are summed once; no
    split block is empty."""
    b, h, w, cin, cout = shape
    plan = fc.conv_plan(b, cin, cout, h, w, sms=sms)
    chunks = plan["chunks"]
    assert (chunks - 1) * plan["chunk"] < cin <= chunks * plan["chunk"]
    walked = [k for r in plan["chunk_ranges"] for k in r]
    assert walked == list(range(chunks))
    assert all(len(r) > 0 for r in plan["chunk_ranges"])
    assert len(plan["chunk_ranges"]) == plan["split"] <= chunks
    # (input channel, tap) pairs reduced: each once
    pairs = [(k * plan["chunk"] + c, tap) for k in walked
             for c in range(plan["chunk"]) for tap in range(9)
             if k * plan["chunk"] + c < cin]
    assert len(pairs) == len(set(pairs)) == 9 * cin


def test_conv_plan_splits_only_small_grids():
    """At 132 SMs the 64x128 and 32x64 levels fill the card without
    split-K; 16x32 takes 2 blocks a tile, 8x16 takes 8; a grid of more
    than half the SMs is never split."""
    want = {64: 1, 32: 1, 16: 2, 8: 8}
    for h, w, cin, cout in UNET_CONVS:
        plan = fc.conv_plan(2, cin, cout, h, w)
        assert plan["split"] == want[h], (h, w, cin, cout)
        blocks = plan["grid"][0] * plan["grid"][1] * 2
        assert plan["split"] == 1 or (
            blocks <= 66 and blocks * plan["split"] <= 132)
    assert fc.conv_plan(16, 320, 320, 64, 128)["split"] == 1


def test_conv_plan_fits_shared_memory():
    """The block's windows, weight ring and barriers (and 1024 bytes of
    alignment) within an H100 block's 232,448 bytes; the epilogue's f32
    staging fits in the windows and ring it reuses."""
    plan = fc.conv_plan(2, 320, 320, 64, 128)
    assert plan["smem"] <= fc.SMEM_LIMIT
    assert plan["window_rows"] == 180
    loop = plan["smem"] - 1024 - 2 * fc.CONV_STAGES * 8
    assert fc.CONV_BLOCK_N * (128 + 4) * 4 <= loop


def test_conv_plan_mirrors_the_kernel():
    """The plan's tile, N block, chunk, ring and staging constants are the
    ones csrc/fused_conv.cu compiles."""
    src = (_CSRC / "fused_conv.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert (const("kTileH"), const("kTileW")) == (fc.CONV_TILE_H,
                                                  fc.CONV_TILE_W)
    assert const("kBlockN") == fc.CONV_BLOCK_N
    assert const("kChunk") == fc.CONV_CHUNK
    assert const("kStages") == fc.CONV_STAGES
    assert "sizeof(ConvSmem) + 1024 <= 232448" in src


def test_fused_conv_source_is_the_hopper_design():
    """The bf16 kernel is warp-specialised on wgmma with A from registers
    (ldmatrix at each lane's window pixel) and weights by TMA under
    mbarriers; the activation runs once per (block, chunk) into a
    double-buffered window, not per tap; no warp-level mma is left; the
    f32 kernel stays; split-K has its own reduce kernel."""
    src = (_CSRC / "fused_conv.cu").read_text()
    assert '#include "hopper.cuh"' in src and '"mma.cuh"' not in src
    hopper = src[src.index("__global__ void __launch_bounds__(kBlockThreads"):
                 src.index("__global__ void fused_conv_reduce(")]
    for call in ("hp::wgmma_rs_k160(", "hp::ldmatrix_x4(", "hp::tma_load_3d(",
                 "hp::mbar_wait(", "hp::mbar_arrive(", "hp::reg_alloc<",
                 "hp::reg_dealloc<", "hp::named_barrier(", "hp::make_desc(",
                 "hp::fence_frag(", "act_value("):
        assert call in hopper, call
    # one activation site in the kernel, inside the window store; the tap
    # loop only reads the window
    assert hopper.count("act_value(") == 1
    tap_loop = hopper[hopper.index("for (int tap = 0; tap < kTaps; ++tap) {\n"
                                   "      const int r"):]
    assert "act_value" not in tap_loop
    for gone in ("mma.sync", "mma_bf16(", "ldmatrix_x4_trans", "ld32(",
                 "fused_conv_bf16", "getenv"):
        assert gone not in src, gone
    assert src.count("__global__") == 3      # bf16, split-K reduce, f32
    assert "fused_conv_f32" in src and "conv_map_cache()" in src
    hdr = (_CSRC / "hopper.cuh").read_text()
    assert "m64n160k16" in hdr and "p, 1, 1, 0;" in hdr
    assert "ldmatrix.sync.aligned.m8n8.x4.shared.b16" in hdr


def test_mma_header_keeps_only_used_helpers():
    """Every helper left in mma.cuh is used by some source; the warp-level
    product and the transposed ldmatrix that only the first fused conv
    used are gone."""
    mma = (_CSRC / "mma.cuh").read_text()
    sources = "".join((_CSRC / name).read_text() for name in (
        "flash_attention.cu", "flash_attention_bwd.cu", "fused_conv.cu"))
    names = re.findall(r"__device__ __forceinline__ \w+ (\w+)\(", mma)
    names += re.findall(r"^constexpr \w+ (\w+) =", mma, re.M)
    assert names
    for name in names:
        assert re.search(rf"\b{name}\b", sources), name
    for gone in ("mma_bf16", "ldmatrix", "ld32", "mma.sync"):
        assert gone not in mma.split("#pragma once")[1], gone


def test_relaid_weight_is_kept_per_version():
    """The (Cout, 3, 3, Cin) re-lay is made once per version of the weight:
    two calls return the same tensor; an in-place update, a new dtype or a
    new storage make a fresh one equal to ``relayout_weight``."""
    w = torch.randn(16, 8, 3, 3)
    first = fc.relaid_weight(w, torch.float32)
    assert fc.relaid_weight(w, torch.float32) is first
    assert torch.equal(first, fc.relayout_weight(w, torch.float32))
    w.add_(1)
    second = fc.relaid_weight(w, torch.float32)
    assert second is not first
    assert torch.equal(second, fc.relayout_weight(w, torch.float32))
    assert fc.relaid_weight(w, torch.float32) is second
    bf = fc.relaid_weight(w, torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and torch.equal(
        bf, fc.relayout_weight(w, torch.bfloat16))
    with torch.no_grad():
        w.copy_(torch.zeros_like(w))
    assert torch.equal(fc.relaid_weight(w, torch.bfloat16),
                       torch.zeros(16, 3, 3, 8, dtype=torch.bfloat16))
    p = torch.nn.Parameter(torch.randn(4, 8, 3, 3))
    kept = fc.relaid_weight(p, torch.float32)
    p.data = torch.randn(4, 8, 3, 3)          # a new storage, same version
    assert not torch.equal(fc.relaid_weight(p, torch.float32), kept)
    assert torch.equal(fc.relaid_weight(p, torch.float32),
                       fc.relayout_weight(p, torch.float32))
    with torch.inference_mode():
        inf = torch.randn(4, 8, 3, 3)
        assert torch.equal(fc.relaid_weight(inf, torch.float32),
                           fc.relayout_weight(inf, torch.float32))


def test_optimizer_step_invalidates_the_relaid_weight():
    """An optimizer step updates the weight in place: the next re-lay is of
    the new values."""
    conv = torch.nn.Conv2d(8, 4, 3, padding=1)
    before = fc.relaid_weight(conv.weight, torch.float32)
    opt = torch.optim.SGD(conv.parameters(), lr=0.1)
    conv(torch.randn(1, 8, 5, 5)).sum().backward()
    opt.step()
    after = fc.relaid_weight(conv.weight, torch.float32)
    assert not torch.equal(before, after)
    assert torch.equal(after, fc.relayout_weight(conv.weight.detach(),
                                                 torch.float32))
