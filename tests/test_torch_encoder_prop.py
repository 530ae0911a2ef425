"""Encoder propagation (arXiv 2312.09608) in the port against the JAX
package on the CPU, at the tiny configs, f32, ``deterministic_vae=True``
and explicit latents: ``stage2_generate`` and ``stage3_generate`` with
``encoder_cache_interval`` 2 and 3 over 6 DDIM / UniPC steps at the module
bar (atol 1e-4, rtol 1e-3); the key steps the UNet's encoder runs on;
interval 2 over 1 step is interval 1 bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdms_tpu.pipelines.stage2_inpaint import stage2_generate as j_stage2
from pcdms_tpu.pipelines.stage3_refine import stage3_generate as j_stage3

from pcdms_tpu_torch.pipelines.stage2_inpaint import stage2_generate
from pcdms_tpu_torch.pipelines.stage3_refine import stage3_generate

from _torch_common import (
    TINY, TOL, image_proj_pair, n, pose_proj_pair, unet_pair, vae_pair,
)

B, H, W, SAMPLES, STEPS = 1, 64, 64, 2, 6


@functools.lru_cache(maxsize=None)
def _stage2():
    """(JAX params, port modules, positional inputs, latents)."""
    ju, tu = unet_pair(TINY.unet2(True), 101)
    jv, tv = vae_pair(TINY.vae, 102)
    ji, ti = image_proj_pair(103, **TINY.image_proj_kwargs)
    jp, tp = pose_proj_pair(104, **TINY.pose_proj_kwargs)
    rng = np.random.default_rng(105)
    canvas = rng.uniform(-1, 1, (B, H, 2 * W, 3)).astype(np.float32)
    canvas[:, :, W:] = -1.0
    args = (canvas, rng.uniform(-1, 1, (B, H, 2 * W, 3)).astype(np.float32),
            rng.standard_normal((B, 257, 24)).astype(np.float32),
            rng.standard_normal((B, 1, 16)).astype(np.float32))
    latents = rng.standard_normal(
        (B * SAMPLES, H // 8, 2 * W // 8, 4)).astype(np.float32)
    return ({"unet": ju, "vae": jv, "image_proj": ji, "pose_proj": jp},
            {"unet": tu, "vae": tv, "image_proj": ti, "pose_proj": tp},
            args, latents)


@functools.lru_cache(maxsize=None)
def _stage3():
    ju, tu = unet_pair(TINY.unet3, 106)
    jv, tv = vae_pair(TINY.vae, 107)
    ji, ti = image_proj_pair(108, **TINY.image_proj_kwargs)
    rng = np.random.default_rng(109)
    args = (rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
            rng.standard_normal((B, 257, 24)).astype(np.float32))
    latents = rng.standard_normal(
        (B * SAMPLES, H // 8, W // 8, 4)).astype(np.float32)
    return ({"unet": ju, "vae": jv, "image_proj": ji},
            {"unet": tu, "vae": tv, "image_proj": ti}, args, latents)


STAGES = {"stage2": (_stage2, stage2_generate, j_stage2,
                     lambda: TINY.unet2(True)),
          "stage3": (_stage3, stage3_generate, j_stage3,
                     lambda: TINY.unet3)}


def _port(stage, **kw):
    models, generate, _, _ = STAGES[stage]
    _, tmodels, args, latents = models()
    kw = dict(dict(num_steps=STEPS, scheduler="ddim", num_samples=SAMPLES,
                   guidance_scale=2.0, deterministic_vae=True,
                   decode=False), **kw)
    return generate(tmodels, *args, latents=latents,
                    compute_dtype=torch.float32, device="cpu", **kw)


@pytest.mark.parametrize("interval", [2, 3])
@pytest.mark.parametrize("scheduler", ["ddim", "unipc"])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_encoder_propagation_matches_jax(stage, scheduler, interval):
    models, _, j_generate, unet_cfg = STAGES[stage]
    jparams, _, args, latents = models()
    kw = dict(num_steps=STEPS, scheduler=scheduler, num_samples=SAMPLES,
              guidance_scale=2.0, deterministic_vae=True, decode=False,
              encoder_cache_interval=interval)
    want = j_generate(jparams, *args, jax.random.PRNGKey(0), latents,
                      unet_cfg=unet_cfg(), vae_cfg=TINY.vae,
                      compute_dtype=jnp.float32, **kw)
    got = _port(stage, **kw)
    assert got.shape == latents.shape
    np.testing.assert_allclose(n(got), n(want), **TOL)
    exact = _port(stage, scheduler=scheduler)
    assert not np.allclose(n(got), n(exact), **TOL)


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_one_step_at_interval_two_is_interval_one(stage):
    """Only step 0 runs, and it is a key step: the cached route (time
    embedding, encode, decode) gives the full forward's bits."""
    np.testing.assert_array_equal(
        n(_port(stage, num_steps=1, encoder_cache_interval=2)),
        n(_port(stage, num_steps=1)))


@pytest.mark.parametrize("scheduler", ["ddim", "unipc"])
@pytest.mark.parametrize("interval,keys", [(2, [0, 2, 4, 6]), (3, [0, 3, 6])])
def test_encoder_runs_on_the_key_steps(monkeypatch, scheduler, interval,
                                       keys):
    """Every interval-th step and step 0 encode; every step decodes once,
    with no full forward (the JAX package's step_i % interval == 0)."""
    unet = _stage2()[1]["unet"]
    calls = []
    for name in ("encode", "decode", "forward"):
        fn = getattr(unet, name)

        def counted(*a, _name=name, _fn=fn, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(unet, name, counted)
    _port("stage2", num_steps=7, scheduler=scheduler,
          encoder_cache_interval=interval)
    assert "forward" not in calls and calls.count("decode") == 7
    step, at = 0, []
    for c in calls:
        if c == "encode":
            at.append(step)
        else:
            step += 1
    assert at == keys
