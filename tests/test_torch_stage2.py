"""The slice end to end: the port's ``stage2_generate`` against the JAX
package's at the tiny configs, f32, ``deterministic_vae=True`` and explicit
numpy latents, DDIM and UniPC (4 steps), full and demo variants, latents
and images, at the module bar (atol 1e-4, rtol 1e-3)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdms_tpu.models.vae import vae_decode
from pcdms_tpu.pipelines.stage2_inpaint import (
    build_half_mask as j_build_half_mask, stage2_generate as j_generate,
)

from pcdms_tpu_torch.pipelines.stage2_inpaint import (
    build_half_mask, stage2_generate,
)
from pcdms_tpu_torch.utils.device import resolve_device

from _torch_common import (
    TINY, TOL, image_proj_pair, n, pose_proj_pair, unet_pair, vae_pair,
)

B, H, W2, SAMPLES, STEPS = 1, 64, 128, 2, 4


@functools.lru_cache(maxsize=None)
def _models(with_class_embed: bool):
    """(JAX params, port modules) with the same non-zero weights."""
    ju, tu = unet_pair(TINY.unet2(with_class_embed), 31)
    jv, tv = vae_pair(TINY.vae, 32)
    ji, ti = image_proj_pair(33, **TINY.image_proj_kwargs)
    jp, tp = pose_proj_pair(34, **TINY.pose_proj_kwargs)
    return ({"unet": ju, "vae": jv, "image_proj": ji, "pose_proj": jp},
            {"unet": tu, "vae": tv, "image_proj": ti, "pose_proj": tp})


def _inputs(with_class_embed: bool):
    rng = np.random.default_rng(40)
    canvas = rng.uniform(-1, 1, (B, H, W2, 3)).astype(np.float32)
    canvas[:, :, W2 // 2:] = -1.0                   # black target half
    pose = rng.uniform(-1, 1, (B, H, W2, 3)).astype(np.float32)
    dino = rng.standard_normal((B, 257, 24)).astype(np.float32)
    emb = (rng.standard_normal((B, 1, 16)).astype(np.float32)
           if with_class_embed else None)
    latents = rng.standard_normal(
        (B * SAMPLES, H // 8, W2 // 8, 4)).astype(np.float32)
    return canvas, pose, dino, emb, latents


_j_vae_decode = jax.jit(vae_decode, static_argnums=2)


@pytest.mark.parametrize("variant", ["full", "demo"])
@pytest.mark.parametrize("scheduler", ["ddim", "unipc"])
def test_stage2_generate_matches_jax(scheduler, variant):
    full = variant == "full"
    jparams, tmodels = _models(full)
    canvas, pose, dino, emb, latents = _inputs(full)
    kw = dict(num_steps=STEPS, scheduler=scheduler, num_samples=SAMPLES,
              guidance_scale=2.0, deterministic_vae=True, decode=False)
    want = j_generate(jparams, canvas, pose, dino, emb,
                      jax.random.PRNGKey(0), latents,
                      unet_cfg=TINY.unet2(full), vae_cfg=TINY.vae,
                      compute_dtype=jnp.float32, **kw)
    got = stage2_generate(tmodels, canvas, pose, dino, emb, latents=latents,
                          compute_dtype=torch.float32, device="cpu", **kw)
    assert got.shape == (B * SAMPLES, H // 8, W2 // 8, 4)
    np.testing.assert_allclose(n(got), n(want), **TOL)

    # images: JAX stage2_generate's decode=True tail, vae_decode of its
    # latents in the compute dtype, against the port's decode=True output
    kw["decode"] = True
    images = stage2_generate(tmodels, canvas, pose, dino, emb,
                             latents=latents, compute_dtype=torch.float32,
                             device="cpu", **kw)
    want_images = _j_vae_decode(jparams["vae"], want, TINY.vae)
    assert images.shape == (B * SAMPLES, H, W2, 3)
    assert torch.isfinite(images).all()
    np.testing.assert_allclose(n(images), n(want_images), **TOL)


def test_stage2_generate_images_end_to_end():
    """One run with images straight out of JAX stage2_generate(decode=True)
    (UniPC, full variant)."""
    jparams, tmodels = _models(True)
    canvas, pose, dino, emb, latents = _inputs(True)
    kw = dict(num_steps=STEPS, scheduler="unipc", num_samples=SAMPLES,
              guidance_scale=2.0, deterministic_vae=True, decode=True)
    want = j_generate(jparams, canvas, pose, dino, emb,
                      jax.random.PRNGKey(0), latents,
                      unet_cfg=TINY.unet2(True), vae_cfg=TINY.vae,
                      compute_dtype=jnp.float32, **kw)
    got = stage2_generate(tmodels, canvas, pose, dino, emb, latents=latents,
                          compute_dtype=torch.float32, device="cpu", **kw)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_half_mask_matches_jax():
    np.testing.assert_array_equal(
        n(build_half_mask(2, 3, 8, torch.float32)),
        n(j_build_half_mask(2, 3, 8, jnp.float32)))


@pytest.mark.parametrize("option", [
    dict(scheduler="lcm"), dict(scheduler="lcm", encoder_cache_interval=2),
    dict(scheduler="euler")])
def test_deferred_options_raise(option):
    """The port refuses what the JAX package refuses, with its ValueError:
    LCM without a w-conditioned UNet (before its clash with encoder
    propagation, as there), and a scheduler neither side has."""
    jparams, tmodels = _models(True)
    canvas, pose, dino, emb, latents = _inputs(True)
    kw = dict(num_samples=SAMPLES, deterministic_vae=True, decode=False,
              **option)
    with pytest.raises(ValueError, match="w-conditioned|unknown scheduler"):
        stage2_generate(tmodels, canvas, pose, dino, emb, latents=latents,
                        compute_dtype=torch.float32, device="cpu", **kw)
    if option["scheduler"] == "lcm":
        with pytest.raises(ValueError, match="w-conditioned"):
            j_generate(jparams, canvas, pose, dino, emb,
                       jax.random.PRNGKey(0), latents,
                       unet_cfg=TINY.unet2(True), vae_cfg=TINY.vae,
                       compute_dtype=jnp.float32, **kw)


def test_lcm_with_encoder_propagation_raises():
    """A w-conditioned UNet still refuses LCM with encoder propagation, on
    both sides (few-step sampling)."""
    import dataclasses
    cfg = dataclasses.replace(TINY.unet2(True), time_cond_proj_dim=8)
    jparams, tmodels = _models(True)
    jparams = dict(jparams, unet=unet_pair(cfg, 35)[0])
    tmodels = dict(tmodels, unet=unet_pair(cfg, 35)[1])
    canvas, pose, dino, emb, latents = _inputs(True)
    kw = dict(num_samples=SAMPLES, deterministic_vae=True, decode=False,
              scheduler="lcm", encoder_cache_interval=2)
    with pytest.raises(ValueError, match="don't compose"):
        stage2_generate(tmodels, canvas, pose, dino, emb, latents=latents,
                        compute_dtype=torch.float32, device="cpu", **kw)
    with pytest.raises(ValueError, match="don't compose"):
        j_generate(jparams, canvas, pose, dino, emb, jax.random.PRNGKey(0),
                   latents, unet_cfg=cfg, vae_cfg=TINY.vae,
                   compute_dtype=jnp.float32, **kw)


@pytest.mark.parametrize("field,value", [("freeu", (1.0, 1.0, 1.0, 1.0)),
                                         ("time_cond_proj_dim", 8)])
def test_unet_options_build(field, value):
    """The UNet options that used to be refused build and run (their
    parity with the JAX UNet is in test_torch_sampler_options.py)."""
    import dataclasses
    from pcdms_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig
    cfg = dataclasses.replace(UNetConfig(block_out_channels=(8, 16, 16, 16),
                                         norm_groups=4, head_dim=8,
                                         cross_attention_dim=16,
                                         use_flash=False),
                              **{field: value})
    model = UNet2DConditionModel(cfg).eval()
    cond = (torch.ones((1, value)) if field == "time_cond_proj_dim"
            else None)
    with torch.no_grad():
        out = model(torch.randn((1, 8, 8, 9)), torch.tensor([10]),
                    torch.randn((1, 3, 16)), timestep_cond=cond)
    assert out.shape == (1, 8, 8, 4) and torch.isfinite(out).all()


def test_device_resolution(monkeypatch):
    assert resolve_device("cpu").type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")


def test_models_left_untouched_by_dtype_cast():
    """The entry point casts into the compute dtype without mutating the
    caller's modules, as the JAX package leaves its f32 params alone."""
    _, tmodels = _models(False)
    canvas, pose, dino, emb, latents = _inputs(False)
    before = {k: v.clone() for k, v in tmodels["unet"].state_dict().items()}
    out = stage2_generate(tmodels, canvas, pose, dino, emb,
                          latents=latents[:B], num_steps=1,
                          scheduler="ddim", decode=False,
                          compute_dtype=torch.bfloat16, device="cpu",
                          deterministic_vae=True)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    after = tmodels["unet"].state_dict()
    assert all(after[k].dtype == torch.float32 and torch.equal(after[k], v)
               for k, v in before.items())
