"""The stage-1 sampler on the CPU at the tiny config, f32: the port's
``stage1_generate`` against the JAX package's at one step with the same
initial latents (the one step's noise is scaled by the 1e-10 variance
floor, so the two streams do not matter), and at four steps, with and
without CFG, against a loop of the JAX package's public functions fed the
noise the port draws from the same seeded generator; all at the module bar
(atol 1e-4, rtol 1e-3). Then the port's per-row ``seeds=`` streams: a row
comes out the same alone as in a batch."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdms_tpu.diffusion.guidance import apply_cfg as j_apply_cfg
from pcdms_tpu.diffusion.schedules import prior_schedule as j_prior_schedule
from pcdms_tpu.diffusion.unclip import (
    unclip_clip_x0 as j_clip_x0, unclip_step_tables as j_step_tables,
)
from pcdms_tpu.models.prior_transformer import (
    prior_apply, prior_post_process_latents as j_post_process,
)
from pcdms_tpu.pipelines.stage1_prior import stage1_generate as j_generate

from pcdms_tpu_torch.models.prior_transformer import PriorConfig
from pcdms_tpu_torch.pipelines.stage1_prior import stage1_generate

from _torch_common import TINY, TOL, n, prior_pair

B, E = 3, 16


@functools.lru_cache(maxsize=None)
def _models():
    params, model = prior_pair(TINY.prior, 41)
    return params, {"prior": model}


def _inputs(seed=42):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, E)).astype(np.float32),
            rng.uniform(0, 1, (B, 36)).astype(np.float32),
            rng.uniform(0, 1, (B, 36)).astype(np.float32),
            rng.standard_normal((B, E)).astype(np.float32))


@pytest.mark.parametrize("guidance_scale", [0.0, 4.0])
def test_one_step_matches_jax(guidance_scale):
    params, models = _models()
    s_embed, s_pose, t_pose, latents = _inputs()
    want = j_generate(params, s_embed, s_pose, t_pose, jax.random.PRNGKey(0),
                      latents, prior_cfg=TINY.prior, num_steps=1,
                      guidance_scale=guidance_scale)
    got = stage1_generate(models, s_embed, s_pose, t_pose, latents=latents,
                          num_steps=1, guidance_scale=guidance_scale,
                          device="cpu")
    assert got.shape == (B, E) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), **TOL)


def _jax_loop(params, s_embed, s_pose, t_pose, x, noise, steps,
              guidance_scale):
    """``stage1_generate``'s scan body (pcdms_tpu/pipelines/stage1_prior.py)
    as a loop of the JAX package's functions, with the noise given."""
    ts, cx0, cxt, std = j_step_tables(j_prior_schedule(), steps)
    use_cfg = guidance_scale > 1.0
    proj = (jnp.concatenate([jnp.zeros_like(s_embed), s_embed])
            if use_cfg else s_embed)
    x = jnp.asarray(x)
    for i in range(steps):
        lat = jnp.concatenate([x] * 2) if use_cfg else x
        tt = jnp.full((lat.shape[0],), ts[i], jnp.int32)
        pred = prior_apply(params, TINY.prior, lat, tt, proj, s_pose, t_pose,
                           cfg_zero_cond=use_cfg)
        if use_cfg:
            pred = j_apply_cfg(pred, guidance_scale)
        x = cx0[i] * j_clip_x0(pred) + cxt[i] * x + std[i] * noise[i]
    return j_post_process(x)


@pytest.mark.parametrize("given_latents", [True, False])
@pytest.mark.parametrize("guidance_scale", [0.0, 4.0])
def test_four_steps_match_jax_loop(guidance_scale, given_latents):
    """The generator draws the initial latents (unless given) and then one
    (B, E) normal per step, in that order."""
    params, models = _models()
    s_embed, s_pose, t_pose, latents = _inputs()
    got = stage1_generate(
        models, s_embed, s_pose, t_pose,
        generator=torch.Generator().manual_seed(7),
        latents=latents if given_latents else None, num_steps=4,
        guidance_scale=guidance_scale, device="cpu")
    g = torch.Generator().manual_seed(7)
    draws = [torch.randn((B, E), generator=g).numpy()
             for _ in range(4 if given_latents else 5)]
    x0 = latents if given_latents else draws.pop(0)
    want = _jax_loop(params, s_embed, s_pose, t_pose, x0, draws, 4,
                     guidance_scale)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_seeds_batch_composition_invariance():
    """seeds= draws each row's initial latents and step noise from its own
    stream: a row comes out the same alone as inside a batch, whatever the
    generator (after tests/test_pipelines.py's stage-1 test)."""
    _, models = _models()
    s_embed, s_pose, t_pose, _ = _inputs()
    seeds = np.array([4, 5, 6])
    kw = dict(num_steps=4, guidance_scale=0.0, device="cpu")
    full = stage1_generate(models, s_embed, s_pose, t_pose,
                           torch.Generator().manual_seed(1), seeds=seeds,
                           **kw)
    solo = stage1_generate(models, s_embed[1:2], s_pose[1:2], t_pose[1:2],
                           torch.Generator().manual_seed(2),
                           seeds=seeds[1:2], **kw)
    np.testing.assert_allclose(n(full[1]), n(solo[0]), rtol=1e-5, atol=1e-5)
    assert not np.allclose(n(full[0]), n(full[2]))
    again = stage1_generate(models, s_embed, s_pose, t_pose, seeds=seeds,
                            **kw)
    np.testing.assert_array_equal(n(again), n(full))


def test_prior_cfg_must_match_the_module():
    _, models = _models()
    s_embed, s_pose, t_pose, _ = _inputs()
    with pytest.raises(ValueError):
        stage1_generate(models, s_embed, s_pose, t_pose, num_steps=1,
                        prior_cfg=PriorConfig(), device="cpu")
