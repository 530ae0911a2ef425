"""The port's modules against their JAX counterparts, f32 on the CPU, with
the same non-zero random weights on both sides (``compat/from_jax``), at
the JAX suite's module bar (atol 1e-4, rtol 1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdms_tpu.compat.torch_convert import (
    convert_image_proj, convert_pose_proj, convert_unet, convert_vae,
    state_dict_to_numpy,
)
from pcdms_tpu.diffusion.ddim import ddim_step_tables as j_ddim_tables
from pcdms_tpu.diffusion.schedules import sd21_schedule as j_sd21
from pcdms_tpu.diffusion.unipc import unipc_coeffs as j_unipc_coeffs
from pcdms_tpu.models.projections import (
    image_proj_mlp_apply, pose_cond_embedding_apply,
)
from pcdms_tpu.models.unet2d import unet_apply
from pcdms_tpu.models.vae import vae_decode, vae_encode_moments
from pcdms_tpu.nn import layers as jl
from pcdms_tpu.nn.transformer import (
    transformer_block_apply, transformer_block_init,
)
from pcdms_tpu.nn.unet_blocks import (
    resnet_block_apply, resnet_block_init, transformer2d_apply,
    transformer2d_init,
)

from pcdms_tpu_torch.diffusion.ddim import ddim_step_tables
from pcdms_tpu_torch.diffusion.schedules import sd21_schedule
from pcdms_tpu_torch.diffusion.unipc import unipc_coeffs
from pcdms_tpu_torch.compat import from_jax
from pcdms_tpu_torch.nn import layers as tl
from pcdms_tpu_torch.nn.transformer import BasicTransformerBlock
from pcdms_tpu_torch.nn.unet_blocks import ResnetBlock2D, Transformer2DModel

from _torch_common import (
    TINY, TOL, image_proj_pair, n, nonzero, pose_proj_pair, t, unet_pair,
    vae_pair,
)


def _close(got, want, **tol):
    np.testing.assert_allclose(n(got), n(want), **(tol or TOL))


def _nchw(x):
    return t(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layer_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3 + 1
    p = nonzero(jl.layer_norm_init(24), 1)
    ln = tl.LayerNorm(24)
    from_jax.load_numpy_state_dict(ln, {"weight": p["scale"],
                                        "bias": p["bias"]})
    _close(ln(t(x)), jl.layer_norm_apply(p, x))


@pytest.mark.parametrize("shift", [0.0, 300.0])
def test_group_norm(shift):
    """shift=300 makes the first group near-constant with a large mean, where
    the single-pass variance cancels to noise (either sign): the clamp at 0
    keeps both sides finite there, and the other groups still match."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 5, 16)).astype(np.float32)
    x[:, :, :, :4] = shift + 1e-4 * x[:, :, :, :4]
    p = nonzero(jl.group_norm_init(16), 2)
    gn = tl.GroupNorm(4, 16, eps=1e-6)
    from_jax.load_numpy_state_dict(gn, {"weight": p["scale"],
                                        "bias": p["bias"]})
    want = jl.group_norm_apply(p, x, 4, 1e-6)
    got = _nhwc(gn(_nchw(x)))
    assert np.isfinite(n(got)).all() and np.isfinite(n(want)).all()
    live = slice(4 if shift else 0, None)    # the cancelling group is noise
    _close(got[..., live], np.asarray(want)[..., live])
    tokens = x.reshape(2, 30, 16)
    got1d = gn(t(tokens).transpose(1, 2)).transpose(1, 2)
    want1d = np.asarray(jl.group_norm_1d_apply(p, tokens, 4, 1e-6))
    assert np.isfinite(n(got1d)).all()
    _close(got1d[..., live], want1d[..., live])


def test_activations_and_timestep_embedding():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 17)).astype(np.float32) * 4
    _close(tl.gelu(t(x)), jl.gelu(x))
    _close(tl.silu(t(x)), jl.silu(x))
    ts = np.array([0, 1, 250, 999], np.int32)
    for dim, flip, shift in ((320, True, 0.0), (33, False, 1.0)):
        _close(tl.timestep_sinusoidal_embedding(t(ts), dim, flip, shift),
               jl.timestep_sinusoidal_embedding(jnp.asarray(ts), dim, flip,
                                                shift))


def test_timestep_embedding_with_cond_proj():
    rng = np.random.default_rng(3)
    p = nonzero(jl.timestep_embedding_init(jax.random.PRNGKey(0), 8, 32,
                                           cond_proj_dim=6), 3)
    mod = tl.TimestepEmbedding(8, 32, cond_proj_dim=6)
    sd = {}
    from_jax._timestep_embedding(sd, "te", p)
    from_jax.load_numpy_state_dict(
        mod, {k[3:]: v for k, v in sd.items()})
    x = rng.standard_normal((2, 8)).astype(np.float32)
    c = rng.standard_normal((2, 6)).astype(np.float32)
    _close(mod(t(x), t(c)), jl.timestep_embedding_apply(p, x, c))
    _close(mod(t(x)), jl.timestep_embedding_apply(p, x))


def test_upsample2x_conv3x3():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    p = nonzero(jl.conv2d_init(jax.random.PRNGKey(1), 6, 4, 3), 4)
    conv = torch.nn.Conv2d(6, 4, 3, padding=1)
    sd = {}
    from_jax._conv(sd, "c", p)
    from_jax.load_numpy_state_dict(conv, {k[2:]: v for k, v in sd.items()})
    got = _nhwc(tl.upsample2x_conv3x3(conv, _nchw(x)))
    _close(got, jl.upsample2x_conv3x3(p, x))


# ---------------------------------------------------------------------------
# transformer / UNet blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero_ctx_prefix", [0, 2])
def test_transformer_block(zero_ctx_prefix):
    rng = np.random.default_rng(5)
    dim, heads, hd, ctx_dim = 16, 2, 8, 12
    p = nonzero(transformer_block_init(jax.random.PRNGKey(2), dim, heads, hd,
                                       context_dim=ctx_dim), 5)
    blk = BasicTransformerBlock(dim, heads, hd, context_dim=ctx_dim)
    sd = {}
    from_jax._transformer_block(sd, "b", p)
    from_jax.load_numpy_state_dict(blk, {k[2:]: v for k, v in sd.items()})
    x = rng.standard_normal((4, 10, dim)).astype(np.float32)
    ctx = rng.standard_normal((4, 7, ctx_dim)).astype(np.float32)
    ctx[:zero_ctx_prefix] = 0.0
    want = transformer_block_apply(p, x, ctx, heads=heads,
                                   zero_ctx_prefix=zero_ctx_prefix)
    got = blk(t(x), t(ctx), zero_ctx_prefix=zero_ctx_prefix)
    _close(got, want)
    if zero_ctx_prefix:
        # the shortcut is exact: same as computing the zero-context rows
        _close(got, blk(t(x), t(ctx)), atol=1e-5, rtol=1e-5)


def test_resnet_block():
    rng = np.random.default_rng(6)
    p = nonzero(resnet_block_init(jax.random.PRNGKey(3), 8, 16, 32), 6)
    blk = ResnetBlock2D(8, 16, 32, groups=4)
    sd = {}
    from_jax._resnet(sd, "r", p)
    from_jax.load_numpy_state_dict(blk, {k[2:]: v for k, v in sd.items()})
    x = rng.standard_normal((2, 6, 10, 8)).astype(np.float32)
    temb = rng.standard_normal((2, 32)).astype(np.float32)
    want = resnet_block_apply(p, x, temb, num_groups=4)
    _close(_nhwc(blk(_nchw(x), t(temb))), want)


def test_transformer2d():
    rng = np.random.default_rng(7)
    p = nonzero(transformer2d_init(jax.random.PRNGKey(4), 16, 2, 8, 12), 7)
    mod = Transformer2DModel(16, 2, 8, 12, groups=4)
    sd = {}
    from_jax._transformer2d(sd, "a", p)
    from_jax.load_numpy_state_dict(mod, {k[2:]: v for k, v in sd.items()})
    x = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 12)).astype(np.float32)
    want = transformer2d_apply(p, x, ctx, heads=2, num_groups=4)
    _close(_nhwc(mod(_nchw(x), t(ctx))), want)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_class_embed", [True, False])
def test_unet(with_class_embed):
    cfg = TINY.unet2(with_class_embed)
    params, model = unet_pair(cfg, 11)
    rng = np.random.default_rng(8)
    b = 4
    sample = rng.standard_normal((b, 16, 32, 9)).astype(np.float32)
    ts = np.array([999, 500, 1, 250], np.int32)
    ctx = rng.standard_normal((b, 6, 16)).astype(np.float32)
    ctx[:2] = 0.0
    pose = rng.standard_normal((b, 16, 32, 8)).astype(np.float32)
    labels = (rng.standard_normal((b, 16)).astype(np.float32)
              if with_class_embed else None)
    want = jax.jit(unet_apply, static_argnums=1,
                   static_argnames="zero_ctx_prefix")(
        params, cfg, sample, ts, ctx, class_labels=labels, pose_cond=pose,
        zero_ctx_prefix=2)
    with torch.no_grad():
        got = model(t(sample), t(ts), t(ctx),
                    class_labels=None if labels is None else t(labels),
                    pose_cond=t(pose), zero_ctx_prefix=2)
    assert got.shape == want.shape
    _close(got, want)


def test_vae_encode_decode():
    cfg = TINY.vae
    params, model = vae_pair(cfg, 12)
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    want_mean, want_logvar = jax.jit(vae_encode_moments, static_argnums=2)(
        params, x, cfg)
    z = rng.standard_normal((2, 4, 8, 4)).astype(np.float32)
    with torch.no_grad():
        mean, logvar = model.encode_moments(t(x))
        img = model.decode(t(z))
    _close(mean, want_mean)
    _close(logvar, want_logvar)
    _close(img, jax.jit(vae_decode, static_argnums=2)(params, z, cfg))


def test_projections():
    rng = np.random.default_rng(10)
    kw = TINY.image_proj_kwargs
    p, mod = image_proj_pair(13, **kw)
    x = rng.standard_normal((2, 5, kw["in_dim"])).astype(np.float32)
    _close(mod(t(x)), image_proj_mlp_apply(p, x))
    pk = TINY.pose_proj_kwargs
    p, mod = pose_proj_pair(14, **pk)
    pose = rng.uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = mod(t(pose))
    want = pose_cond_embedding_apply(p, pose)
    assert np.abs(n(want)).max() > 0.01      # the pose path is live
    _close(got, want)


# ---------------------------------------------------------------------------
# schedules (exact) and the weight round trip (exact)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [4, 20, 50])
def test_sampler_tables_exact(steps):
    js, ts = j_sd21(), sd21_schedule()
    for name in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    want_ddim = j_ddim_tables(js, steps)
    got_ddim = ddim_step_tables(ts, steps)
    assert not want_ddim[3].any()                     # sigma at eta = 0
    assert len(got_ddim) == len(want_ddim) == 4
    for a, b in zip(got_ddim, want_ddim):
        np.testing.assert_array_equal(a, b)
    jc, tc = j_unipc_coeffs(js, steps), unipc_coeffs(ts, steps)
    for name in jc.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name))


def _assert_tree_equal(got, want):
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in flat_got] == [k for k, _ in flat_want]
    for (_, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("part", ["unet", "unet_demo", "vae", "image_proj",
                                  "pose_proj"])
def test_weight_round_trip_exact(part):
    """JAX pytree -> port module -> state_dict -> torch_convert -> the same
    pytree, key for key and bit for bit."""
    if part.startswith("unet"):
        params, mod = unet_pair(TINY.unet2(part == "unet"), 21)
        convert = convert_unet
    elif part == "vae":
        params, mod = vae_pair(TINY.vae, 22)
        convert = convert_vae
    elif part == "image_proj":
        params, mod = image_proj_pair(23, **TINY.image_proj_kwargs)
        convert = convert_image_proj
    else:
        params, mod = pose_proj_pair(24, **TINY.pose_proj_kwargs)
        convert = convert_pose_proj
    _assert_tree_equal(convert(state_dict_to_numpy(mod.state_dict())),
                       params)
