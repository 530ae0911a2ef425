"""The fused GroupNorm + SiLU + conv3x3 (kernel 7) on the CPU: the port's
plain version (what the CUDA kernel is held against on the card) against the
JAX package's Pallas kernel in interpret mode, in every mode, at the JAX
suite's shape and at one with Cin != Cout inside JAX's Pallas domain (f32 at
atol 1e-4 / rtol 1e-3; bf16 at 1e-2 of the largest magnitude, one bf16 ulp
after a different accumulation order); ``gn_affine_coeffs``; and a tiny
UNet and ``stage2_generate`` with ``fused_conv=True`` against JAX's (its
XLA fallback on the CPU, the same function). The port is NCHW with torch
(Cout, Cin, 3, 3) weights, JAX NHWC with HWIO: the inputs are transposed."""

import dataclasses

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
