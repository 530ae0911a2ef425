"""Stage 3 on the CPU at the tiny configs, f32: the 8-channel UNet against
JAX ``unet_apply``, and the port's ``stage3_generate`` against the JAX
package's for DDIM and UniPC (4 steps), two samples per input, latents and
images, ``deterministic_vae=True`` and explicit latents, at the module bar
(atol 1e-4, rtol 1e-3); then the schedulers stage 3 refuses."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdms_tpu.models.unet2d import unet_apply
from pcdms_tpu.models.vae import vae_decode
from pcdms_tpu.pipelines.stage3_refine import stage3_generate as j_generate

from pcdms_tpu_torch.pipelines.stage3_refine import stage3_generate

from _torch_common import (
    TINY, TOL, image_proj_pair, n, t, unet_pair, vae_pair,
)

B, H, W, SAMPLES, STEPS = 1, 64, 64, 2, 4


@functools.lru_cache(maxsize=None)
def _models():
    ju, tu = unet_pair(TINY.unet3, 51)
    jv, tv = vae_pair(TINY.vae, 52)
    ji, ti = image_proj_pair(53, **TINY.image_proj_kwargs)
    return ({"unet": ju, "vae": jv, "image_proj": ji},
            {"unet": tu, "vae": tv, "image_proj": ti})


def _inputs():
    rng = np.random.default_rng(54)
    gen = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    dino = rng.standard_normal((B, 257, 24)).astype(np.float32)
    latents = rng.standard_normal(
        (B * SAMPLES, H // 8, W // 8, 4)).astype(np.float32)
    return gen, dino, latents


@pytest.mark.parametrize("zero_ctx_prefix", [0, 2])
def test_stage3_unet_matches_jax(zero_ctx_prefix):
    """The 8-channel stage-3 UNet (no class embedding, no pose map)."""
    params, model = unet_pair(TINY.unet3, 55)
    rng = np.random.default_rng(56)
    b = 4
    sample = rng.standard_normal((b, 16, 16, 8)).astype(np.float32)
    ts = np.array([999, 500, 1, 250], np.int32)
    ctx = rng.standard_normal((b, 257, 16)).astype(np.float32)
    ctx[:zero_ctx_prefix] = 0.0
    want = jax.jit(unet_apply, static_argnums=1,
                   static_argnames="zero_ctx_prefix")(
        params, TINY.unet3, sample, ts, ctx,
        zero_ctx_prefix=zero_ctx_prefix)
    with torch.no_grad():
        got = model(t(sample), t(ts), t(ctx),
                    zero_ctx_prefix=zero_ctx_prefix)
    assert got.shape == want.shape == (b, 16, 16, 4)
    np.testing.assert_allclose(n(got), n(want), **TOL)


_j_vae_decode = jax.jit(vae_decode, static_argnums=2)


@pytest.mark.parametrize("scheduler", ["ddim", "unipc"])
def test_stage3_generate_matches_jax(scheduler):
    jparams, tmodels = _models()
    gen, dino, latents = _inputs()
    kw = dict(num_steps=STEPS, scheduler=scheduler, num_samples=SAMPLES,
              guidance_scale=2.0, deterministic_vae=True, decode=False)
    want = j_generate(jparams, gen, dino, jax.random.PRNGKey(0), latents,
                      unet_cfg=TINY.unet3, vae_cfg=TINY.vae,
                      compute_dtype=jnp.float32, **kw)
    got = stage3_generate(tmodels, gen, dino, latents=latents,
                          compute_dtype=torch.float32, device="cpu", **kw)
    assert got.shape == (B * SAMPLES, H // 8, W // 8, 4)
    np.testing.assert_allclose(n(got), n(want), **TOL)

    # images: vae_decode of the JAX latents (stage3_generate's decode=True
    # tail) against the port's decode=True output
    kw["decode"] = True
    images = stage3_generate(tmodels, gen, dino, latents=latents,
                             compute_dtype=torch.float32, device="cpu", **kw)
    want_images = _j_vae_decode(jparams["vae"], want, TINY.vae)
    assert images.shape == (B * SAMPLES, H, W, 3)
    assert torch.isfinite(images).all()
    np.testing.assert_allclose(n(images), n(want_images), **TOL)


def test_stage3_images_end_to_end():
    """One run with images straight out of JAX stage3_generate(decode=True)
    (UniPC), and the sample-major order: sample i of input b at i*B + b."""
    jparams, tmodels = _models()
    gen, dino, latents = _inputs()
    gen2 = np.concatenate([gen, gen[:, ::-1]])
    dino2 = np.concatenate([dino, dino[:, ::-1]])
    lat2 = np.concatenate([latents, latents[::-1]])
    kw = dict(num_steps=2, scheduler="unipc", num_samples=SAMPLES,
              guidance_scale=2.0, deterministic_vae=True, decode=True)
    want = j_generate(jparams, gen2, dino2, jax.random.PRNGKey(0), lat2,
                      unet_cfg=TINY.unet3, vae_cfg=TINY.vae,
                      compute_dtype=jnp.float32, **kw)
    got = stage3_generate(tmodels, gen2, dino2, latents=lat2,
                          compute_dtype=torch.float32, device="cpu", **kw)
    assert got.shape == (2 * SAMPLES, H, W, 3)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_generator_draws_vae_sample_then_latents():
    """Without deterministic_vae the generator samples the VAE posterior
    first and then the initial latents; the same generator seed gives the
    same images, another seed other ones."""
    _, tmodels = _models()
    gen, dino, _ = _inputs()
    kw = dict(num_steps=1, scheduler="ddim", decode=False,
              compute_dtype=torch.float32, device="cpu")

    def run(seed):
        return n(stage3_generate(tmodels, gen, dino,
                                 torch.Generator().manual_seed(seed), **kw))
    np.testing.assert_array_equal(run(3), run(3))
    assert not np.allclose(run(3), run(4))


@pytest.mark.parametrize("option", [
    dict(scheduler="lcm"), dict(scheduler="lcm", encoder_cache_interval=2),
    dict(scheduler="euler")])
def test_deferred_options_raise(option):
    """Stage 3 has no LCM on either side: the port refuses it, and any
    scheduler it does not have, with a ValueError (encoder propagation and
    eta are held against JAX in test_torch_encoder_prop.py and
    test_torch_sampler_options.py)."""
    _, tmodels = _models()
    gen, dino, latents = _inputs()
    with pytest.raises(ValueError, match="unknown scheduler"):
        stage3_generate(tmodels, gen, dino, latents=latents,
                        compute_dtype=torch.float32, device="cpu", **option)
