"""The port's ViT encoders (DINOv2 and CLIP families) against the JAX
package's ``vit_apply`` at tiny widths, f32, through ``vit_state_dict``
(atol 1e-4 / rtol 1e-3): every output, at the pretraining grid and at a
non-square one that resizes the position embeddings; the state dicts'
round trip through ``convert_dinov2`` / ``convert_clip_vision`` (exact); the
frozen-encoder passes; and the short-kv plain version at CLIP ViT-H's
head_dim 80 against the Pallas kernel in interpret mode (f32 2e-5, bf16
3e-2, the bars of tests/test_torch_flash_attention.py)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdms_tpu.compat.torch_convert import (
    convert_clip_vision, convert_dinov2, state_dict_to_numpy,
)
from pcdms_tpu.models.vit import (
    ViTConfig as JViTConfig, clip_vit_h14_config as j_clip_cfg,
    dinov2_giant_config as j_dino_cfg, interpolate_pos_embed as j_interp,
    vit_apply, vit_init,
)
from pcdms_tpu.ops.flash_attention import _shortkv_attention_3d
from pcdms_tpu.train.encoders import (
    clip_image_embed as j_clip_embed, dino_features as j_dino_features,
)

from pcdms_tpu_torch.cli.common import tiny_configs as t_tiny_configs
from pcdms_tpu_torch.compat.from_jax import (
    load_numpy_state_dict, vit_state_dict,
)
from pcdms_tpu_torch.models.vit import (
    ViTConfig, VisionTransformer, clip_vit_h14_config, dinov2_giant_config,
    interpolate_pos_embed,
)
from pcdms_tpu_torch.ops import flash_attention as fa
from pcdms_tpu_torch.train.encoders import clip_image_embed, dino_features

from _torch_common import TINY, TOL, n, nonzero, port_config, t

FAMILIES = {"dino": TINY.dino, "clip": TINY.clip}


def _pair(family: str, seed: int = 0, use_flash: bool = False):
    cfg = dataclasses.replace(FAMILIES[family], use_flash=use_flash)
    params = nonzero(vit_init(jax.random.PRNGKey(seed), cfg), seed)
    model = VisionTransformer(port_config(cfg, ViTConfig))
    load_numpy_state_dict(model, vit_state_dict(params, cfg))
    return cfg, params, model.eval()


_j_vit_apply = jax.jit(vit_apply, static_argnums=1)


@pytest.mark.parametrize("hw", [(224, 224), (160, 288)], ids=str)
@pytest.mark.parametrize("family", ["dino", "clip"])
def test_vit_matches_jax(family, hw):
    cfg, params, model = _pair(family, seed=3)
    pixels = np.random.default_rng(4).standard_normal(
        (2,) + hw + (3,)).astype(np.float32)
    want = _j_vit_apply(params, cfg, pixels)
    with torch.no_grad():
        got = model(t(pixels))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(n(got[key]), n(want[key]), **TOL)


def test_vit_flash_route_matches_jax():
    """use_flash=True takes the attention router (plain route here)."""
    cfg, params, model = _pair("clip", seed=5, use_flash=True)
    pixels = np.random.default_rng(6).standard_normal(
        (1, 224, 224, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(t(pixels))["image_embeds"]
    np.testing.assert_allclose(
        n(got), n(_j_vit_apply(params, cfg, pixels)["image_embeds"]), **TOL)


@pytest.mark.parametrize("grid", [(16, 16), (5, 8), (9, 4)], ids=str)
def test_interpolate_pos_embed_matches_jax_bicubic(grid):
    """JAX's bicubic (Keys a = -0.5, antialiased when shrinking) on a
    non-square grid, not F.interpolate's."""
    pos = np.random.default_rng(7).standard_normal(
        (1, 1 + 7 * 7, 12)).astype(np.float32)
    got = interpolate_pos_embed(t(pos), *grid)
    np.testing.assert_allclose(n(got), n(j_interp(jnp.asarray(pos), *grid)),
                               **TOL)


@pytest.mark.parametrize("family", ["dino", "clip"])
def test_state_dict_round_trip(family):
    """The port's state_dict() read by the JAX package's converter gives
    back the same pytree, exactly: the names are HuggingFace's."""
    cfg, params, model = _pair(family, seed=8)
    convert = convert_dinov2 if family == "dino" else convert_clip_vision
    back = convert(state_dict_to_numpy(model.state_dict()))
    want_leaves, want_def = jax.tree.flatten(params)
    got_leaves, got_def = jax.tree.flatten(back)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_full_size_configs_match_jax():
    assert dataclasses.asdict(dinov2_giant_config()) == dataclasses.asdict(
        j_dino_cfg())
    assert dataclasses.asdict(clip_vit_h14_config()) == dataclasses.asdict(
        j_clip_cfg())
    assert clip_vit_h14_config().head_dim == 80
    assert dinov2_giant_config().mlp_hidden == j_dino_cfg().mlp_hidden
    assert set(dataclasses.asdict(ViTConfig())) == set(
        dataclasses.asdict(JViTConfig()))
    # the port's --tiny_config encoders are the JAX package's
    tiny = t_tiny_configs()
    for name in ("dino", "clip"):
        assert dataclasses.asdict(getattr(tiny, name)) == dataclasses.asdict(
            getattr(TINY, name))


@pytest.mark.parametrize("family", ["dino", "clip"])
def test_encoder_passes_match_jax(family):
    """dino_features / clip_image_embed: bf16 compute, f32 out."""
    cfg, params, model = _pair(family, seed=9)
    pixels = np.random.default_rng(10).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    if family == "dino":
        got, want = dino_features(model, pixels), j_dino_features(
            params, pixels, cfg=cfg)
    else:
        got, want = clip_image_embed(model, pixels), j_clip_embed(
            params, pixels, cfg=cfg)
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    want = n(want)
    assert np.abs(n(got) - want).max() <= 5e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lq,lk", [(257, 257), (300, 100)])
def test_shortkv_plain_head_dim_80_matches_pallas(lq, lk, dtype):
    d = 80
    rng = np.random.default_rng(lq + lk)
    q, k, v = (rng.standard_normal((3, m, d)).astype(np.float32)
               for m in (lq, lk, lk))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    scale = 1.0 / math.sqrt(d)
    want = _shortkv_attention_3d(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                 jnp.asarray(v, jdt), scale, 128, True)
    got = fa.shortkv_plain(t(q).to(tdt), t(k).to(tdt), t(v).to(tdt), scale)
    bar = 2e-5 if dtype == "f32" else 3e-2
    np.testing.assert_allclose(n(got), n(want), atol=bar, rtol=bar)
