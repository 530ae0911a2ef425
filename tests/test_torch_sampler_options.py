"""The sampler options of the port against the JAX package on the CPU, at
the tiny configs, f32: the tables exactly (the linear schedule, the DDIM
tables with eta, the LCM timesteps), the functions at the module bar (atol
1e-4, rtol 1e-3: the guidance-scale embedding, the LCM boundary scalings,
FreeU's Fourier filter, the UNet with FreeU and the w-conditioned UNet),
and the noisy loops of ``stage2_generate`` / ``stage3_generate`` (ancestral
DDIM, also with encoder propagation, and LCM) against the JAX pipelines
with their loops replaced by test-side loops of the JAX package's own
functions that take the noise the port draws (torch cannot draw threefry
noise)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcdms_tpu.pipelines.sampling as j_sampling
from pcdms_tpu.diffusion import schedules as j_schedules
from pcdms_tpu.diffusion.ddim import ddim_step_tables as j_ddim_tables
from pcdms_tpu.models.unet2d import unet_apply
from pcdms_tpu.nn.layers import guidance_scale_embedding as j_gs_embedding
from pcdms_tpu.nn.unet_blocks import fourier_filter as j_fourier_filter
from pcdms_tpu.pipelines.stage2_inpaint import stage2_generate as j_stage2
from pcdms_tpu.pipelines.stage3_refine import stage3_generate as j_stage3
from pcdms_tpu.train.lcm_distill import (
    lcm_boundary_scalings as j_boundary_scalings,
)

from pcdms_tpu_torch.diffusion.ddim import ddim_step_tables
from pcdms_tpu_torch.diffusion.schedules import sd21_schedule
from pcdms_tpu_torch.nn.layers import guidance_scale_embedding
from pcdms_tpu_torch.nn.unet_blocks import fourier_filter
from pcdms_tpu_torch.pipelines.sampling import lcm_inference_timesteps
from pcdms_tpu_torch.pipelines.stage2_inpaint import stage2_generate
from pcdms_tpu_torch.pipelines.stage3_refine import stage3_generate
from pcdms_tpu_torch.train.lcm_distill import lcm_boundary_scalings

from _torch_common import (
    TINY, TOL, image_proj_pair, n, pose_proj_pair, t, unet_pair, vae_pair,
)

B, H, W, SAMPLES = 1, 64, 64, 2
W_COND = dataclasses.replace(TINY.unet2(True), time_cond_proj_dim=8)
SD21_FREEU = (0.9, 0.2, 1.4, 1.6)     # SD-2.1's published FreeU values


# ---------------------------------------------------------------------------
# tables, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [4, 20, 50])
@pytest.mark.parametrize("eta", [0.0, 0.3, 1.0])
def test_ddim_step_tables_match_jax(eta, steps):
    got = ddim_step_tables(sd21_schedule(), steps, eta=eta)
    want = j_ddim_tables(j_schedules.sd21_schedule(), steps, eta=eta)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got[3] > 0).all() == (eta > 0)


@pytest.mark.parametrize("num_steps,origin_steps", [
    (1, 50), (2, 50), (4, 50), (8, 50), (50, 50), (60, 50), (4, 20),
    (3, 25), (6, 1000), (4, 1)])
def test_lcm_inference_timesteps_match_jax(num_steps, origin_steps):
    got = lcm_inference_timesteps(1000, num_steps, origin_steps)
    want = j_sampling.lcm_inference_timesteps(1000, num_steps, origin_steps)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("origin_steps", [7, 0, 2000])
def test_lcm_inference_timesteps_refuse_what_jax_refuses(origin_steps):
    for fn in (lcm_inference_timesteps, j_sampling.lcm_inference_timesteps):
        with pytest.raises(ValueError, match="must divide"):
            fn(1000, 4, origin_steps)


# ---------------------------------------------------------------------------
# functions, at the module bar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [256, 8, 9])
def test_guidance_scale_embedding_matches_jax(dim):
    w = np.array([1.0, 2.0, 1.5, 0.3], np.float32)
    got = guidance_scale_embedding(t(w), dim)
    want = j_gs_embedding(jnp.asarray(w), dim)
    assert got.shape == want.shape == (4, dim)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_guidance_scale_embedding_at_large_scales():
    """At w up to 15 the sines' f32 arguments reach 14000, where one ulp of
    the frequency (a different exp) moves them by |arg| 2^-23: both
    packages against float64, within 4 such ulps."""
    w = np.array([2.5, 7.5, 15.0], np.float32)
    dim = 256
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / (half - 1.0))
    args = ((w.astype(np.float64) - 1.0) * 1000.0)[:, None] * freqs
    want = np.concatenate([np.sin(args), np.cos(args)], axis=-1)
    atol = 4 * float(args.max()) * 2.0 ** -23
    for got in (n(guidance_scale_embedding(t(w), dim)),
                n(j_gs_embedding(jnp.asarray(w), dim))):
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_lcm_boundary_scalings_match_jax():
    ts = np.array([0, 1, 19, 259, 499, 999], np.float32)
    for got, want in zip(lcm_boundary_scalings(t(ts)),
                         j_boundary_scalings(jnp.asarray(ts))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(n(got), n(want), **TOL)
    c_skip, c_out = lcm_boundary_scalings(0)
    assert float(c_skip) == 1.0 and float(c_out) == 0.0


@pytest.mark.parametrize("scale", [0.2, 0.9, 1.0])
@pytest.mark.parametrize("threshold", [1, 2])
@pytest.mark.parametrize("shape", [(2, 3, 8, 16), (1, 2, 7, 5),
                                   (1, 2, 1, 2), (2, 4, 2, 4)], ids=str)
def test_fourier_filter_matches_jax(shape, threshold, scale):
    """NCHW in the port, NHWC in JAX; odd and even sizes, sizes below the
    box."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    got = fourier_filter(t(x), threshold, scale)
    want = j_fourier_filter(jnp.asarray(x.transpose(0, 2, 3, 1)), threshold,
                            scale)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want).transpose(0, 3, 1, 2), **TOL)


def test_fourier_filter_keeps_bf16():
    x = torch.randn((1, 4, 8, 16)).to(torch.bfloat16)
    out = fourier_filter(x, 1, 1.0)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), x.float(), atol=0, rtol=2 ** -8)


_j_unet = jax.jit(unet_apply, static_argnums=1,
                  static_argnames="zero_ctx_prefix")


def _unet_inputs(b=2, h=16, w=32, seed=81):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, 9)).astype(np.float32),
            np.array([999, 251][:b], np.int32),
            rng.standard_normal((b, 258, 16)).astype(np.float32),
            rng.standard_normal((b, 16)).astype(np.float32),
            rng.standard_normal((b, h, w, 8)).astype(np.float32))


def _both_unets(params, model, cfg, timestep_cond=None):
    sample, ts, ctx, labels, pose = _unet_inputs()
    want = _j_unet(params, cfg, sample, ts, ctx, class_labels=labels,
                   pose_cond=pose, timestep_cond=timestep_cond)
    with torch.no_grad():
        got = model(t(sample), t(ts), t(ctx), t(labels), t(pose),
                    timestep_cond=None if timestep_cond is None
                    else t(np.array(timestep_cond)))
    return got, want


@pytest.mark.parametrize("freeu", [(1.0, 1.0, 1.0, 1.0), SD21_FREEU,
                                   (1.1, 0.5, 0.8, 1.2)], ids=str)
def test_freeu_unet_matches_jax(freeu):
    cfg = dataclasses.replace(TINY.unet2(True), freeu=freeu)
    params, model = unet_pair(cfg, 82)
    got, want = _both_unets(params, model, cfg)
    assert got.shape == want.shape == (2, 16, 32, 4)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_neutral_freeu_equals_none():
    """(1, 1, 1, 1) scales nothing: only the f32 FFT round trip remains."""
    _, model = unet_pair(TINY.unet2(True), 83)
    sample, ts, ctx, labels, pose = (t(x) for x in _unet_inputs())
    with torch.no_grad():
        plain = model(sample, ts, ctx, labels, pose)
        model.cfg = dataclasses.replace(model.cfg, freeu=(1.0, 1.0, 1.0, 1.0))
        neutral = model(sample, ts, ctx, labels, pose)
        model.cfg = dataclasses.replace(model.cfg, freeu=SD21_FREEU)
        scaled = model(sample, ts, ctx, labels, pose)
    np.testing.assert_allclose(n(neutral), n(plain), **TOL)
    assert not np.allclose(n(scaled), n(plain), **TOL)


def test_w_conditioned_unet_matches_jax():
    """The LCM student's cond_proj crosses over through compat/from_jax and
    takes the guidance-scale embedding."""
    params, model = unet_pair(W_COND, 84)
    assert model.time_embedding.cond_proj.weight.shape == (8, 8)
    cond = j_gs_embedding(jnp.array([2.0, 4.5]), 8)
    got, want = _both_unets(params, model, W_COND, timestep_cond=cond)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    without, _ = _both_unets(params, model, W_COND)
    assert not np.allclose(n(got), n(without), **TOL)


# ---------------------------------------------------------------------------
# the noisy loops: the JAX pipelines with the noise the port draws
# ---------------------------------------------------------------------------

def _ddim_loop_with(noise):
    """JAX ``ddim_sample_loop``'s eta > 0 scan body as a loop, with
    noise[i] in place of its i-th draw."""
    def loop(schedule, model_eps, x, num_steps, unroll=1, eta=0.0, rng=None,
             model_carry=None):
        ts, cx0, ceps, sigma = j_ddim_tables(schedule, num_steps, eta=eta)
        sa = schedule.sqrt_alphas_cumprod[ts]
        ssg = schedule.sqrt_one_minus_alphas_cumprod[ts]
        model = jax.jit(model_eps)
        for i in range(num_steps):
            tt = jnp.asarray(ts[i])
            if model_carry is None:
                eps = model(x, tt)
            else:
                eps, model_carry = model(x, tt, model_carry)
            x0 = (x - ssg[i] * eps) / sa[i]
            x = cx0[i] * x0 + ceps[i] * eps + sigma[i] * jnp.asarray(
                noise[i])
        return x
    return loop


def _lcm_loop_with(noise):
    """JAX ``lcm_sample_loop`` with noise[i] in place of its i-th draw."""
    def loop(schedule, model_eps, x, num_steps, rng, *, origin_steps=50,
             sigma_data=0.5, timestep_scaling=10.0):
        ts = j_sampling.lcm_inference_timesteps(
            schedule.num_train_timesteps, num_steps, origin_steps)
        a = jnp.asarray(schedule.sqrt_alphas_cumprod)
        s = jnp.asarray(schedule.sqrt_one_minus_alphas_cumprod)
        model = jax.jit(model_eps)
        for i, tv in enumerate(ts):
            eps = model(x, jnp.asarray(tv, jnp.int32))
            x0 = (x - s[tv] * eps) / a[tv]
            c_skip, c_out = j_boundary_scalings(
                jnp.asarray(float(tv)), sigma_data, timestep_scaling)
            x = c_skip * x + c_out * x0
            if i < len(ts) - 1:
                x = a[ts[i + 1]] * x + s[ts[i + 1]] * jnp.asarray(noise[i])
        return x
    return loop


def _draws(seed, count, shape):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).numpy() for _ in range(count)]


@functools.lru_cache(maxsize=None)
def _stage2_models(unet_cfg):
    ju, tu = unet_pair(unet_cfg, 85)
    jv, tv = vae_pair(TINY.vae, 86)
    ji, ti = image_proj_pair(87, **TINY.image_proj_kwargs)
    jp, tp = pose_proj_pair(88, **TINY.pose_proj_kwargs)
    return ({"unet": ju, "vae": jv, "image_proj": ji, "pose_proj": jp},
            {"unet": tu, "vae": tv, "image_proj": ti, "pose_proj": tp})


def _stage2_inputs(samples, seed=89):
    rng = np.random.default_rng(seed)
    canvas = rng.uniform(-1, 1, (B, H, 2 * W, 3)).astype(np.float32)
    canvas[:, :, W:] = -1.0
    pose = rng.uniform(-1, 1, (B, H, 2 * W, 3)).astype(np.float32)
    dino = rng.standard_normal((B, 257, 24)).astype(np.float32)
    emb = rng.standard_normal((B, 1, 16)).astype(np.float32)
    latents = rng.standard_normal(
        (B * samples, H // 8, 2 * W // 8, 4)).astype(np.float32)
    return (canvas, pose, dino, emb), latents


@pytest.mark.parametrize("interval", [1, 2])
def test_stage2_ancestral_ddim_matches_jax_loop(monkeypatch, interval):
    """eta = 0.5: the generator draws one (n, h, w, 4) normal after each
    step (deterministic VAE, latents given); with interval 2 the cached
    encoder features ride along (JAX test_eta_path_supports_cache)."""
    steps = 4
    jparams, tmodels = _stage2_models(TINY.unet2(True))
    args, latents = _stage2_inputs(SAMPLES)
    kw = dict(num_steps=steps, scheduler="ddim", num_samples=SAMPLES,
              guidance_scale=2.0, deterministic_vae=True, decode=False,
              eta=0.5, encoder_cache_interval=interval)
    got = stage2_generate(tmodels, *args, torch.Generator().manual_seed(5),
                          latents=latents, compute_dtype=torch.float32,
                          device="cpu", **kw)
    monkeypatch.setattr(j_sampling, "ddim_sample_loop", _ddim_loop_with(
        _draws(5, steps, latents.shape)))
    want = j_stage2.__wrapped__(jparams, *args, jax.random.PRNGKey(0),
                                latents, unet_cfg=TINY.unet2(True),
                                vae_cfg=TINY.vae, compute_dtype=jnp.float32,
                                **kw)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    plain = stage2_generate(tmodels, *args, latents=latents,
                            compute_dtype=torch.float32, device="cpu",
                            **dict(kw, eta=0.0))
    assert not np.allclose(n(got), n(plain), **TOL)


def test_stage2_lcm_matches_jax_loop(monkeypatch):
    """LCM on the w-conditioned student: no CFG doubling, the guidance
    scale through the embedding, a draw after every step but the last."""
    steps = 4
    jparams, tmodels = _stage2_models(W_COND)
    args, latents = _stage2_inputs(SAMPLES)
    kw = dict(num_steps=steps, scheduler="lcm", num_samples=SAMPLES,
              guidance_scale=2.5, deterministic_vae=True, decode=False,
              lcm_origin_steps=50)
    calls = []
    unet = tmodels["unet"]
    hook = unet.register_forward_pre_hook(
        lambda _, a: calls.append(a[0].shape[0]))
    try:
        got = stage2_generate(tmodels, *args,
                              torch.Generator().manual_seed(6),
                              latents=latents, compute_dtype=torch.float32,
                              device="cpu", **kw)
    finally:
        hook.remove()
    assert calls == [B * SAMPLES] * steps           # no CFG doubling
    monkeypatch.setattr(j_sampling, "lcm_sample_loop", _lcm_loop_with(
        _draws(6, steps - 1, latents.shape)))
    want = j_stage2.__wrapped__(jparams, *args, jax.random.PRNGKey(0),
                                latents, unet_cfg=W_COND, vae_cfg=TINY.vae,
                                compute_dtype=jnp.float32, **kw)
    np.testing.assert_allclose(n(got), n(want), **TOL)


@pytest.mark.parametrize("scheduler", ["ddim", "unipc"])
def test_stage2_w_conditioned_unet_matches_jax(scheduler):
    """A w-conditioned UNet under DDIM and UniPC, as the JAX package runs
    it: the guidance scale embedded, no CFG doubling."""
    jparams, tmodels = _stage2_models(W_COND)
    args, latents = _stage2_inputs(SAMPLES)
    kw = dict(num_steps=3, scheduler=scheduler, num_samples=SAMPLES,
              guidance_scale=2.0, deterministic_vae=True, decode=False)
    got = stage2_generate(tmodels, *args, latents=latents,
                          compute_dtype=torch.float32, device="cpu", **kw)
    want = j_stage2(jparams, *args, jax.random.PRNGKey(0), latents,
                    unet_cfg=W_COND, vae_cfg=TINY.vae,
                    compute_dtype=jnp.float32, **kw)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_stage2_freeu_matches_jax():
    """stage2_generate on a FreeU UNet (UniPC, images)."""
    cfg = dataclasses.replace(TINY.unet2(True), freeu=SD21_FREEU)
    jparams, tmodels = _stage2_models(cfg)
    args, latents = _stage2_inputs(SAMPLES)
    kw = dict(num_steps=3, scheduler="unipc", num_samples=SAMPLES,
              guidance_scale=2.0, deterministic_vae=True, decode=True)
    got = stage2_generate(tmodels, *args, latents=latents,
                          compute_dtype=torch.float32, device="cpu", **kw)
    want = j_stage2(jparams, *args, jax.random.PRNGKey(0), latents,
                    unet_cfg=cfg, vae_cfg=TINY.vae,
                    compute_dtype=jnp.float32, **kw)
    assert got.shape == (B * SAMPLES, H, 2 * W, 3)
    np.testing.assert_allclose(n(got), n(want), **TOL)


@functools.lru_cache(maxsize=None)
def _stage3_models():
    ju, tu = unet_pair(TINY.unet3, 90)
    jv, tv = vae_pair(TINY.vae, 91)
    ji, ti = image_proj_pair(92, **TINY.image_proj_kwargs)
    return ({"unet": ju, "vae": jv, "image_proj": ji},
            {"unet": tu, "vae": tv, "image_proj": ti})


def _stage3_inputs(seed=93):
    rng = np.random.default_rng(seed)
    gen = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    dino = rng.standard_normal((B, 257, 24)).astype(np.float32)
    latents = rng.standard_normal(
        (B * SAMPLES, H // 8, W // 8, 4)).astype(np.float32)
    return (gen, dino), latents


@pytest.mark.parametrize("interval", [1, 2])
def test_stage3_ancestral_ddim_matches_jax_loop(monkeypatch, interval):
    steps = 4
    jparams, tmodels = _stage3_models()
    args, latents = _stage3_inputs()
    kw = dict(num_steps=steps, scheduler="ddim", num_samples=SAMPLES,
              guidance_scale=2.0, deterministic_vae=True, decode=False,
              eta=0.7, encoder_cache_interval=interval)
    got = stage3_generate(tmodels, *args, torch.Generator().manual_seed(8),
                          latents=latents, compute_dtype=torch.float32,
                          device="cpu", **kw)
    monkeypatch.setattr(j_sampling, "ddim_sample_loop", _ddim_loop_with(
        _draws(8, steps, latents.shape)))
    want = j_stage3.__wrapped__(jparams, *args, jax.random.PRNGKey(0),
                                latents, unet_cfg=TINY.unet3,
                                vae_cfg=TINY.vae, compute_dtype=jnp.float32,
                                **kw)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_ancestral_ddim_draws_after_vae_and_latents():
    """Without deterministic_vae or latents the generator draws the VAE
    sample, the initial latents, then the step noise: the same seed gives
    the same bits, another seed other ones."""
    _, tmodels = _stage3_models()
    (gen, dino), _ = _stage3_inputs()
    kw = dict(num_steps=2, scheduler="ddim", eta=1.0, decode=False,
              compute_dtype=torch.float32, device="cpu")

    def run(seed):
        return n(stage3_generate(tmodels, gen, dino,
                                 torch.Generator().manual_seed(seed), **kw))
    np.testing.assert_array_equal(run(3), run(3))
    assert not np.allclose(run(3), run(4))
