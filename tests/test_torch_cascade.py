"""The three-stage cascade on the CPU at the tiny configs, f32: the port's
``cascade_generate`` (one prior step, explicit stage-1 / 2 / 3 latents,
``seeds=`` for the deterministic VAE) against the JAX package's three stage
functions chained as ``pcdms_tpu/pipelines/cascade.py`` chains them, at the
module bar (atol 1e-4, rtol 1e-3) for the embeddings, the inpainted canvas
and the refined target, exact and with encoder propagation; then the per-row ``seeds=`` contract and the
refusal of explicit latents without seeds."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdms_tpu.pipelines.stage1_prior import stage1_generate as j_stage1
from pcdms_tpu.pipelines.stage2_inpaint import stage2_generate as j_stage2
from pcdms_tpu.pipelines.stage3_refine import stage3_generate as j_stage3

from pcdms_tpu_torch.pipelines.cascade import cascade_generate

from _torch_common import (
    TINY, TOL, image_proj_pair, n, pose_proj_pair, prior_pair, unet_pair,
    vae_pair,
)

H, W, STEPS = 64, 64, 2


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX params, port modules) of the three stages; stages 2 and 3
    share the VAE, as in the reference."""
    jp, tp = prior_pair(TINY.prior, 61)
    jv, tv = vae_pair(TINY.vae, 62)
    j2u, t2u = unet_pair(TINY.unet2(True), 63)
    j2i, t2i = image_proj_pair(64, **TINY.image_proj_kwargs)
    j2p, t2p = pose_proj_pair(65, **TINY.pose_proj_kwargs)
    j3u, t3u = unet_pair(TINY.unet3, 66)
    j3i, t3i = image_proj_pair(67, **TINY.image_proj_kwargs)
    jax_params = (jp, {"unet": j2u, "image_proj": j2i, "pose_proj": j2p,
                       "vae": jv},
                  {"unet": j3u, "image_proj": j3i, "vae": jv})
    port = ({"prior": tp}, {"unet": t2u, "image_proj": t2i,
                            "pose_proj": t2p, "vae": tv},
            {"unet": t3u, "image_proj": t3i, "vae": tv})
    return jax_params, port


def _inputs(b, seed=68):
    rng = np.random.default_rng(seed)
    canvas = rng.uniform(-1, 1, (b, H, 2 * W, 3)).astype(np.float32)
    canvas[:, :, W:] = -1.0
    return dict(
        s_embed=rng.standard_normal((b, 16)).astype(np.float32),
        s_pose=rng.uniform(0, 1, (b, 36)).astype(np.float32),
        t_pose=rng.uniform(0, 1, (b, 36)).astype(np.float32),
        vae_image=canvas,
        st_pose=rng.uniform(-1, 1, (b, H, 2 * W, 3)).astype(np.float32),
        dino=rng.standard_normal((b, 257, 24)).astype(np.float32))


def _args(x):
    return (x["s_embed"], x["s_pose"], x["t_pose"], x["vae_image"],
            x["st_pose"], x["dino"])


def _check_against_jax_chain(interval):
    (jp, j2, j3), port = _models()
    b = 2
    x = _inputs(b)
    rng = np.random.default_rng(69)
    s1 = rng.standard_normal((b, 16)).astype(np.float32)
    s2 = rng.standard_normal((b, H // 8, 2 * W // 8, 4)).astype(np.float32)
    s3 = rng.standard_normal((b, H // 8, W // 8, 4)).astype(np.float32)
    got = cascade_generate(*port, *_args(x), seeds=[3, 4], s1_latents=s1,
                           s2_latents=s2, s3_latents=s3, prior_steps=1,
                           inpaint_steps=STEPS, refine_steps=STEPS,
                           scheduler="ddim", compute_dtype=torch.float32,
                           encoder_cache_interval=interval, device="cpu")

    # pcdms_tpu/pipelines/cascade.py's chain, with the latents given and
    # the VAE at its posterior mean (what seeds= gives there)
    key = jax.random.PRNGKey(0)
    common = dict(vae_cfg=TINY.vae, guidance_scale=2.0, scheduler="ddim",
                  compute_dtype=jnp.float32, deterministic_vae=True,
                  encoder_cache_interval=interval)
    embeds = j_stage1(jp, x["s_embed"], x["s_pose"], x["t_pose"], key, s1,
                      prior_cfg=TINY.prior, num_steps=1, guidance_scale=0.0)
    inpainted = j_stage2(j2, x["vae_image"], x["st_pose"], x["dino"],
                         embeds[:, None, :], key, s2,
                         unet_cfg=TINY.unet2(True), num_steps=STEPS,
                         **common)
    refined = j_stage3(j3, inpainted[:, :, W:, :], x["dino"], key, s3,
                       unet_cfg=TINY.unet3, num_steps=STEPS, **common)
    want = {"embeds": embeds, "inpainted": inpainted, "refined": refined}
    shapes = {"embeds": (b, 16), "inpainted": (b, H, 2 * W, 3),
              "refined": (b, H, W, 3)}
    for name, shape in shapes.items():
        assert got[name].shape == want[name].shape == shape, name
        np.testing.assert_allclose(n(got[name]), n(want[name]), **TOL,
                                   err_msg=name)


def test_cascade_matches_jax_chain():
    _check_against_jax_chain(1)


def test_cascade_with_encoder_propagation_matches_jax_chain():
    """encoder_cache_interval=2 reaches both stages: step 0 full, step 1
    decode-only (STEPS = 2)."""
    _check_against_jax_chain(2)


def test_seeds_batch_composition_invariance():
    """With seeds= a row's three outputs are the same alone as inside a
    batch (the bounds of tests/test_pipelines.py's cascade test)."""
    _, port = _models()
    x = _inputs(3, seed=70)
    kw = dict(prior_steps=2, inpaint_steps=STEPS, refine_steps=STEPS,
              scheduler="ddim", compute_dtype=torch.float32, device="cpu")
    seeds = np.array([7, 8, 9])
    full = cascade_generate(*port, *_args(x),
                            torch.Generator().manual_seed(12), seeds=seeds,
                            **kw)
    solo = cascade_generate(*port, *(a[1:2] for a in _args(x)),
                            torch.Generator().manual_seed(99),
                            seeds=seeds[1:2], **kw)
    for name, atol in (("embeds", 1e-5), ("inpainted", 1e-3),
                       ("refined", 1e-3)):
        np.testing.assert_allclose(n(full[name][1]), n(solo[name][0]),
                                   rtol=1e-4, atol=atol, err_msg=name)
    assert not np.allclose(n(full["refined"][0]), n(full["refined"][2]))


def test_explicit_latents_require_seeds():
    _, port = _models()
    x = _inputs(1)
    with pytest.raises(ValueError, match="seeds"):
        cascade_generate(*port, *_args(x),
                         s1_latents=np.zeros((1, 16), np.float32),
                         prior_steps=1, inpaint_steps=1, refine_steps=1,
                         device="cpu")
