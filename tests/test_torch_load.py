"""Weight loading (``pcdms_tpu_torch/compat/load.py``, ``compat/safetensors.py``)
against the JAX package's loader (``pcdms_tpu/compat/load.py``), on the
CPU at the tiny geometry, from files in every layout the reference
ecosystem writes, saved here from seeded random weights: diffusers
directories (``.bin`` and ``.safetensors``), the VAE under its old
mid-attention names, the monolithic PCDMs checkpoints (a DeepSpeed
``module`` wrapper, ``module.`` keys, a ``state_dict`` wrapper), a prior
file, an HF CLIP directory with its ``position_ids`` buffer and an HF
DINOv2 directory at a larger grid with its ``mask_token``.

For each layout the port's state dict equals ``compat/from_jax.py`` applied
to the JAX loader's parameters, exactly, but for resized position
embeddings (at most 1e-6 apart); each module's forward from the loaded
weights agrees with the JAX forward at the module bar (f32 atol 1e-4,
rtol 1e-3). A key the JAX converter reads and the file lacks raises
``KeyError`` on both sides. The safetensors reader agrees with
``safetensors.torch.load_file`` for every dtype it reads and refuses the
others, as the JAX loader does. The JAX CLIs and the port's CLIs make the
same outputs from the same files: stage 1 (the ``.npy`` at the module bar),
stage 2 in test and train mode and stage 3 (PNGs within 3 uint8 levels);
and the stage-2 trainer grows a 4-channel ``conv_in`` with zeros."""

import dataclasses
import functools
import json
import logging
import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch as st
import torch
from PIL import Image

import pcdms_tpu.cli.common as j_common
import pcdms_tpu.cli.stage2_train as j_train
import pcdms_tpu.pipelines.stage1_prior as j_stage1
import pcdms_tpu.pipelines.stage2_inpaint as j_stage2
import pcdms_tpu.pipelines.stage3_refine as j_stage3
import pcdms_tpu.train.encoders as j_encoders
from pcdms_tpu.compat import load as j_load
from pcdms_tpu.compat.torch_convert import convert_unet as j_convert_unet
from pcdms_tpu.models.prior_transformer import prior_apply
from pcdms_tpu.models.projections import (
    image_proj_mlp_apply, pose_cond_embedding_apply,
)
from pcdms_tpu.models.unet2d import unet_apply
from pcdms_tpu.models.vae import vae_decode, vae_encode_moments
from pcdms_tpu.models.vit import vit_apply, vit_init
from pcdms_tpu.parallel.mesh import make_mesh

import pcdms_tpu_torch.pipelines.stage1_prior as t_stage1
import pcdms_tpu_torch.pipelines.stage2_inpaint as t_stage2
import pcdms_tpu_torch.pipelines.stage3_refine as t_stage3
import pcdms_tpu_torch.train.encoders as t_encoders
from pcdms_tpu_torch.cli import (
    stage1_batchtest, stage2_batchtest, stage2_train, stage3_batchtest,
)
from pcdms_tpu_torch.compat import from_jax
from pcdms_tpu_torch.compat import load as t_load
from pcdms_tpu_torch.compat.safetensors import DTYPES, load_file
from pcdms_tpu_torch.models.prior_transformer import (
    PriorConfig, PriorTransformer,
)
from pcdms_tpu_torch.models.projections import (
    ImageProjModel, PoseCondEmbedding,
)
from pcdms_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig
from pcdms_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from pcdms_tpu_torch.models.vit import ViTConfig, VisionTransformer
from pcdms_tpu_torch.pose.keypoints import write_pose_txt

from _torch_common import (
    TINY, TOL, image_proj_pair, n, nonzero, port_config, pose_proj_pair,
    prior_pair, t, unet_pair, vae_pair,
)

POS_KEYS = ("embeddings.position_embeddings",)
# DINOv2 in the files: the tiny geometry at a 10 x 10 patch grid (101
# positions), loaded at the tiny module's 7 x 7 or the JAX loader's default
# 16 x 16
DINO_FILE_CFG = dataclasses.replace(TINY.dino, image_size=320)
OLD_VAE_NAMES = {"to_q": "query", "to_k": "key", "to_v": "value",
                 "to_out.0": "proj_attn"}


def _vit_pair(cfg, seed):
    params = nonzero(vit_init(jax.random.PRNGKey(seed), cfg), seed)
    model = VisionTransformer(port_config(cfg, ViTConfig))
    from_jax.load_numpy_state_dict(model, from_jax.vit_state_dict(params,
                                                                  cfg))
    return params, model.eval()


@pytest.fixture(scope="module")
def weights():
    """{part: HF / diffusers-named numpy state dict} of seeded non-zero
    weights, every part of the three stages."""
    parts = {
        "unet2": (unet_pair(TINY.unet2(True), 1)[0],
                  from_jax.unet_state_dict),
        "unet3": (unet_pair(TINY.unet3, 2)[0], from_jax.unet_state_dict),
        "vae": (vae_pair(TINY.vae, 3)[0], from_jax.vae_state_dict),
        "image_proj": (image_proj_pair(4, **TINY.image_proj_kwargs)[0],
                       from_jax.image_proj_state_dict),
        "pose_proj": (pose_proj_pair(5, **TINY.pose_proj_kwargs)[0],
                      from_jax.pose_proj_state_dict),
        "prior": (prior_pair(TINY.prior, 6)[0], from_jax.prior_state_dict),
        "clip": (_vit_pair(TINY.clip, 7)[0],
                 functools.partial(_vit_sd, cfg=TINY.clip)),
        "dino": (_vit_pair(DINO_FILE_CFG, 8)[0],
                 functools.partial(_vit_sd, cfg=DINO_FILE_CFG)),
    }
    return {k: to_sd(jax.tree.map(np.asarray, p))
            for k, (p, to_sd) in parts.items()}


def _vit_sd(params, cfg):
    return from_jax.vit_state_dict(params, cfg)


def _tensors(sd, prefix=""):
    return {prefix + k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}


def _save(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if path.endswith(".safetensors"):
        st.save_file(obj, path)
    else:
        torch.save(obj, path)
    return path


def _old_vae_names(sd):
    out = {}
    for k, v in sd.items():
        for new, old in OLD_VAE_NAMES.items():
            k = k.replace(f"attentions.0.{new}.", f"attentions.0.{old}.")
        out[k] = v
    return out


def _hf_clip(sd):
    out = _tensors(sd)
    n_pos = out["vision_model.embeddings.position_embedding.weight"].shape[0]
    out["vision_model.embeddings.position_ids"] = torch.arange(n_pos)[None]
    return out


def _hf_dino(sd):
    out = _tensors(sd)
    out["embeddings.mask_token"] = torch.zeros(
        1, out["embeddings.cls_token"].shape[-1])
    return out


def _checkpoint(w, parts):
    """{"unet.": ..., "pose_proj.": ...}: reference-prefixed keys."""
    out = {}
    for prefix, part in parts.items():
        out.update(_tensors(w[part], prefix))
    return out


# layout -> (write files under root, return {part: (jax loader's params,
# port loader's state dict)})
def _diffusers(root, w, ext):
    _save(f"{root}/unet/diffusion_pytorch_model{ext}", _tensors(w["unet2"]))
    _save(f"{root}/vae/diffusion_pytorch_model{ext}", _tensors(w["vae"]))
    return {"unet2": (j_load.load_sd_unet(root), t_load.load_sd_unet(root)),
            "vae": (j_load.load_sd_vae(root), t_load.load_sd_vae(root))}


def _vae_old_names(root, w):
    _save(f"{root}/vae/diffusion_pytorch_model.bin",
          _tensors(_old_vae_names(w["vae"])))
    return {"vae": (j_load.load_sd_vae(root), t_load.load_sd_vae(root))}


def _stage2_checkpoint(root, w, wrap, proj_prefix):
    sd = _checkpoint(w, {"unet.": "unet2", "pose_proj.": "pose_proj",
                         proj_prefix: "image_proj"})
    if proj_prefix == "image_proj_model_p.":   # the g projection: not read
        sd.update(_tensors(w["image_proj"], "image_proj_model_g."))
    path = _save(f"{root}/ckpt.pt", wrap(sd))
    got = t_load.load_pcdms_stage2_checkpoint(path)
    want = j_load.load_pcdms_stage2_checkpoint(path)
    assert sorted(got) == sorted(want) == ["image_proj", "pose_proj", "unet"]
    return {"unet2": (want["unet"], got["unet"]),
            "pose_proj": (want["pose_proj"], got["pose_proj"]),
            "image_proj": (want["image_proj"], got["image_proj"])}


def _stage3_checkpoint(root, w):
    sd = _checkpoint(w, {"unet.": "unet3", "image_proj_model.": "image_proj"})
    path = _save(f"{root}/ckpt.pt", {"module": sd})
    got = t_load.load_pcdms_stage3_checkpoint(path)
    want = j_load.load_pcdms_stage3_checkpoint(path)
    assert sorted(got) == sorted(want) == ["image_proj", "unet"]
    return {"unet3": (want["unet"], got["unet"]),
            "image_proj": (want["image_proj"], got["image_proj"])}


def _prior_file(root, w):
    path = _save(f"{root}/prior.bin", _tensors(w["prior"]))
    return {"prior": (j_load.load_prior(path), t_load.load_prior(path))}


def _clip_dir(root, w):
    _save(f"{root}/clip/pytorch_model.bin", _hf_clip(w["clip"]))
    path = f"{root}/clip"
    return {"clip": (j_load.load_clip_vision(path),
                     t_load.load_clip_vision(path))}


def _dino_dir(root, w, grid):
    _save(f"{root}/dino/model.safetensors", _hf_dino(w["dino"]))
    path = f"{root}/dino"
    return {"dino": (j_load.load_dinov2(path, target_grid=grid),
                     t_load.load_dinov2(path, target_grid=grid))}


LAYOUTS = {
    "diffusers_bin": functools.partial(_diffusers, ext=".bin"),
    "diffusers_safetensors": functools.partial(_diffusers,
                                               ext=".safetensors"),
    "vae_old_names": _vae_old_names,
    "stage2_deepspeed_module": functools.partial(
        _stage2_checkpoint, wrap=lambda sd: {"module": sd, "step": 3},
        proj_prefix="image_proj_model_p."),
    "stage2_module_prefix": functools.partial(
        _stage2_checkpoint,
        wrap=lambda sd: {f"module.{k}": v for k, v in sd.items()},
        proj_prefix="image_proj_model."),
    "stage2_state_dict": functools.partial(
        _stage2_checkpoint, wrap=lambda sd: {"state_dict": sd},
        proj_prefix="image_proj_model_p."),
    "stage3_checkpoint": _stage3_checkpoint,
    "prior_file": _prior_file,
    "clip_dir": _clip_dir,
    "dino_dir": functools.partial(_dino_dir, grid=(7, 7)),
    "dino_dir_default_grid": functools.partial(_dino_dir, grid=(16, 16)),
}


def _dino_cfg(jparams):
    grid = int(round((np.asarray(jparams["pos_embed"]).shape[1] - 1) ** 0.5))
    return dataclasses.replace(TINY.dino, image_size=grid * 32)


# part -> (the JAX params -> the port's state dict, the port module)
EXPECTED = {
    "unet2": (from_jax.unet_state_dict,
              lambda p: UNet2DConditionModel(port_config(TINY.unet2(True),
                                                         UNetConfig))),
    "unet3": (from_jax.unet_state_dict,
              lambda p: UNet2DConditionModel(port_config(TINY.unet3,
                                                         UNetConfig))),
    "vae": (from_jax.vae_state_dict,
            lambda p: AutoencoderKL(port_config(TINY.vae, VAEConfig))),
    "image_proj": (from_jax.image_proj_state_dict,
                   lambda p: ImageProjModel(**TINY.image_proj_kwargs)),
    "pose_proj": (from_jax.pose_proj_state_dict,
                  lambda p: PoseCondEmbedding(**TINY.pose_proj_kwargs)),
    "prior": (from_jax.prior_state_dict,
              lambda p: PriorTransformer(port_config(TINY.prior,
                                                     PriorConfig))),
    "clip": (lambda p: from_jax.vit_state_dict(p, TINY.clip),
             lambda p: VisionTransformer(port_config(TINY.clip, ViTConfig))),
    "dino": (lambda p: from_jax.vit_state_dict(p, _dino_cfg(p)),
             lambda p: VisionTransformer(port_config(_dino_cfg(p),
                                                     ViTConfig))),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layout_loads_like_jax(layout, weights, tmp_path):
    """The port's state dict, fitted to its module's keys, is ``from_jax``
    of the JAX loader's params."""
    for part, (jparams, got) in LAYOUTS[layout](str(tmp_path),
                                                 weights).items():
        want = EXPECTED[part][0](jparams)
        got = t_load.fit(got, EXPECTED[part][1](jparams).state_dict(), part)
        assert sorted(got) == sorted(want), part
        for key, value in want.items():
            assert got[key].dtype == torch.float32, key
            if key in POS_KEYS and layout.startswith("dino"):
                np.testing.assert_allclose(got[key].numpy(), value,
                                           atol=1e-6, rtol=0)
            else:
                np.testing.assert_array_equal(got[key].numpy(), value,
                                              err_msg=f"{part} {key}")


_j_unet = jax.jit(unet_apply, static_argnums=1)
_j_vit = jax.jit(vit_apply, static_argnums=1)


def _forwards(part, jparams, model):
    """(port output, JAX output) pairs of ``part``'s forward."""
    rng = np.random.default_rng(9)
    if part.startswith("unet"):
        cfg = TINY.unet2(True) if part == "unet2" else TINY.unet3
        x = rng.standard_normal((2, 8, 16, cfg.in_channels)).astype(
            np.float32)
        ts = np.array([999, 10], np.int32)
        ctx = rng.standard_normal((2, 6, 16)).astype(np.float32)
        kw = {}
        if part == "unet2":
            kw = dict(class_labels=rng.standard_normal((2, 16)).astype(
                np.float32), pose_cond=rng.standard_normal(
                    (2, 8, 16, 8)).astype(np.float32))
        got = model(t(x), t(ts), t(ctx), **{k: t(v) for k, v in kw.items()})
        return [(got, _j_unet(jparams, cfg, x, ts, ctx, **kw))]
    if part == "vae":
        x = rng.uniform(-1, 1, (1, 32, 64, 3)).astype(np.float32)
        z = rng.standard_normal((1, 4, 8, 4)).astype(np.float32)
        mean, logvar = model.encode_moments(t(x))
        j_mean, j_logvar = vae_encode_moments(jparams, x, TINY.vae)
        return [(mean, j_mean), (logvar, j_logvar),
                (model.decode(t(z)), vae_decode(jparams, z, TINY.vae))]
    if part == "image_proj":
        x = rng.standard_normal((2, 5, 24)).astype(np.float32)
        return [(model(t(x)), image_proj_mlp_apply(jparams, x))]
    if part == "pose_proj":
        x = rng.uniform(-1, 1, (1, 32, 64, 3)).astype(np.float32)
        return [(model(t(x)), pose_cond_embedding_apply(jparams, x))]
    if part == "prior":
        noisy, proj = (rng.standard_normal((2, 16)).astype(np.float32)
                       for _ in range(2))
        ts = np.array([5, 700], np.int32)
        poses = [rng.uniform(0, 1, (2, 36)).astype(np.float32)
                 for _ in range(2)]
        return [(model(*map(t, (noisy, ts, proj, *poses))),
                 prior_apply(jparams, TINY.prior, noisy, ts, proj, *poses))]
    cfg = TINY.clip if part == "clip" else _dino_cfg(jparams)
    x = rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
    got, want = model(t(x)), _j_vit(jparams, cfg, x)
    return [(got[k], want[k]) for k in sorted(want)]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layout_forward_matches_jax(layout, weights, tmp_path):
    """Each module built from the port's loaded state dict computes what the
    JAX module computes from the JAX loader's params."""
    for part, (jparams, sd) in LAYOUTS[layout](str(tmp_path),
                                                weights).items():
        model = t_load.load_into(EXPECTED[part][1](jparams), sd, part)
        with torch.no_grad():
            pairs = _forwards(part, jparams, model.eval())
        for got, want in pairs:
            assert tuple(got.shape) == tuple(np.shape(want)), part
            np.testing.assert_allclose(n(got), n(want), **TOL,
                                       err_msg=part)


# a key each JAX converter reads, removed from the file; the port's
# module names it under the port's name
MISSING = {
    "unet": ("diffusers_bin", "unet/diffusion_pytorch_model.bin",
             "unet2", "conv_in.weight", "load_sd_unet", "conv_in.weight"),
    "vae_old_names": ("vae_old_names", "vae/diffusion_pytorch_model.bin",
                      "vae", "decoder.mid_block.attentions.0.proj_attn.weight",
                      "load_sd_vae",
                      "decoder.mid_block.attentions.0.to_out.0.weight"),
    "prior": ("prior_file", "prior.bin", "prior", "prd_embedding",
              "load_prior", "prd_embedding"),
    "clip": ("clip_dir", "clip/pytorch_model.bin", "clip",
             "vision_model.pre_layrnorm.bias", "load_clip_vision",
             "vision_model.pre_layrnorm.bias"),
    "dino": ("dino_dir", "dino/model.safetensors", "dino",
             "encoder.layer.1.layer_scale2.lambda1", "load_dinov2",
             "encoder.layer.1.layer_scale2.lambda1"),
}
MODULES = {
    "unet2": lambda: UNet2DConditionModel(port_config(TINY.unet2(True),
                                                      UNetConfig)),
    "vae": lambda: AutoencoderKL(port_config(TINY.vae, VAEConfig)),
    "prior": lambda: PriorTransformer(port_config(TINY.prior, PriorConfig)),
    "clip": lambda: VisionTransformer(port_config(TINY.clip, ViTConfig)),
    "dino": lambda: VisionTransformer(port_config(TINY.dino, ViTConfig)),
}


@pytest.mark.parametrize("case", sorted(MISSING))
def test_missing_key_raises_like_jax(case, weights, tmp_path):
    """The JAX converter raises ``KeyError`` for the key; the port's
    ``load_into`` raises it for the module's name of that key."""
    layout, rel, part, key, loader, port_key = MISSING[case]
    root = str(tmp_path)
    LAYOUTS[layout](root, weights)         # writes the file(s)
    path = os.path.join(root, rel)
    sd = (load_file(path) if path.endswith(".safetensors")
          else torch.load(path, weights_only=False))
    del sd[key]
    _save(path, sd)
    arg = root if loader in ("load_sd_unet", "load_sd_vae") else (
        path if loader == "load_prior" else os.path.dirname(path))
    with pytest.raises(KeyError, match=re.escape(key)):
        getattr(j_load, loader)(arg)
    with pytest.raises(KeyError, match=re.escape(port_key)):
        t_load.load_into(MODULES[part](), getattr(t_load, loader)(arg), part)


def test_extra_keys_are_logged_and_dropped(weights, tmp_path, caplog):
    sd = _hf_clip(weights["clip"])
    sd["vision_model.extra_buffer"] = torch.ones(3)
    _save(str(tmp_path / "clip" / "pytorch_model.bin"), sd)
    model = MODULES["clip"]()
    with caplog.at_level(logging.INFO, logger="pcdms_tpu_torch.compat.load"):
        got = t_load.fit(t_load.load_clip_vision(str(tmp_path / "clip")),
                         model.state_dict(), "clip")
    assert sorted(got) == sorted(model.state_dict())
    assert "vision_model.extra_buffer" not in got
    assert "vision_model.embeddings.position_ids" not in got
    assert "2 keys not read" in caplog.text


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------

def _values(dtype):
    x = torch.arange(-7, 8, dtype=torch.float64).reshape(3, 5) * 3.25
    if dtype == torch.bool:
        return x > 0
    if dtype in (torch.uint8, torch.uint16, torch.uint32, torch.uint64):
        return x.abs().to(torch.int64).to(dtype)
    return x.to(dtype)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_safetensors_reader_matches_the_package(name, tmp_path):
    """Every dtype the reader reads: the package's tensors exactly (at an
    odd offset too, behind a 3-byte tensor, and an empty one), and the JAX
    loader's f32 values through ``load_state_dict``."""
    dtype = DTYPES[name]
    path = str(tmp_path / "w.safetensors")
    tensors = {"a": _values(dtype), "odd": torch.ones(3, dtype=torch.uint8),
               "b": _values(dtype)[1:], "empty": torch.zeros((0, 2), dtype=dtype)}
    st.save_file(tensors, path, metadata={"format": "pt"})
    got, want = load_file(path), st.load_file(path)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == tensors[key].dtype
        assert torch.equal(got[key], want[key]), key
    with warnings.catch_warnings():        # complex -> real part, both
        warnings.simplefilter("ignore")
        j_sd = j_load.load_state_dict(path)
        t_sd = t_load.load_state_dict(path)
    assert sorted(t_sd) == sorted(j_sd)
    for key in j_sd:
        np.testing.assert_array_equal(t_sd[key].numpy(), j_sd[key])


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2,
                                   torch.float8_e8m0fnu], ids=str)
def test_safetensors_reader_refuses_other_dtypes(dtype, tmp_path):
    """What ``safetensors.numpy`` cannot read, neither loader reads."""
    path = str(tmp_path / "w.safetensors")
    st.save_file({"ok": torch.ones(2), "x": torch.ones(4).to(dtype)}, path)
    with pytest.raises(ValueError, match="'x' has dtype"):
        load_file(path)
    with pytest.raises(ValueError):
        t_load.load_state_dict(path)
    with pytest.raises(AttributeError, match="float8"):
        j_load.load_state_dict(path)


# ---------------------------------------------------------------------------
# the CLIs on loaded weights, the port's against the JAX package's
# ---------------------------------------------------------------------------

NAMES = ["im0", "im1", "im2"]
STEMS = [f"{NAMES[i]}_to_{NAMES[(i + 1) % 3]}" for i in range(3)]


def _images(seed, count, shape=(64, 64, 3)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (count,) + shape, dtype=np.uint8)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """3 images in the DeepFashion layout with pose renders and pose
    ``.txt`` files, stage-1 ``.npy`` embeddings and stage-2 PNGs for each
    pair, and a test and a train pair list."""
    root = tmp_path_factory.mktemp("deepfashion")
    for sub in ("train_all_png", "openpose_all_img", "normalized_pose_txt",
                "prior", "gen"):
        (root / sub).mkdir()
    imgs, poses = _images(0, 3), _images(1, 3)
    rng = np.random.default_rng(2)
    for i, stem in enumerate(NAMES):
        Image.fromarray(imgs[i]).save(root / "train_all_png" / f"{stem}.png")
        Image.fromarray(poses[i]).save(root / "openpose_all_img"
                                       / f"{stem}_pose.jpg")
        write_pose_txt(str(root / "normalized_pose_txt" / f"{stem}.txt"),
                       rng.uniform(0, 1, 36))
    for i, stem in enumerate(STEMS):
        np.save(root / "prior" / f"{stem}.npy",
                rng.standard_normal((1, 16)).astype(np.float32))
        Image.fromarray(_images(10 + i, 1)[0]).save(root / "gen"
                                                    / f"{stem}.png")
    pairs = [{"source_image": f"train_all_png/{NAMES[i]}.jpg",
              "target_image": f"train_all_png/{NAMES[(i + 1) % 3]}.jpg"}
             for i in range(3)]
    for name in ("test_pairs.json", "train_pairs.json"):
        (root / name).write_text(json.dumps(pairs))
    return str(root)


@pytest.fixture(scope="module")
def files(weights, tmp_path_factory):
    """The reference's files for every CLI: the stage-2 checkpoint in a
    DeepSpeed wrapper, the stage-3 one with ``module.`` keys and the demo's
    projection prefix, the prior, the SD-2.1 dir (VAE under its old names),
    DINOv2 at the 16 x 16 grid the JAX loader resizes to, and CLIP."""
    root = str(tmp_path_factory.mktemp("weights"))
    w = weights
    _save(f"{root}/s2.pt", {"module": _checkpoint(w, {
        "unet.": "unet2", "pose_proj.": "pose_proj",
        "image_proj_model_p.": "image_proj"})})
    _save(f"{root}/s3.pt", {f"module.{k}": v for k, v in _checkpoint(w, {
        "unet.": "unet3", "image_proj_model.": "image_proj"}).items()})
    _save(f"{root}/prior.bin", _tensors(w["prior"]))
    _save(f"{root}/sd21/vae/diffusion_pytorch_model.bin",
          _tensors(_old_vae_names(w["vae"])))
    cfg16 = dataclasses.replace(TINY.dino, image_size=512)
    dino16 = jax.tree.map(np.asarray, _vit_pair(cfg16, 9)[0])
    _save(f"{root}/dino16/model.safetensors",
          _hf_dino(from_jax.vit_state_dict(dino16, cfg16)))
    _save(f"{root}/clip/pytorch_model.bin", _hf_clip(w["clip"]))
    return {
        "stage1": ["--weights_name", f"{root}/prior.bin",
                   "--image_encoder_path", f"{root}/clip"],
        "stage2": ["--weights_name", f"{root}/s2.pt",
                   "--pretrained_model_name_or_path", f"{root}/sd21",
                   "--image_encoder_p_path", f"{root}/dino16",
                   "--image_encoder_g_path", f"{root}/clip"],
        "stage3": ["--weights_name", f"{root}/s3.pt",
                   "--pretrained_model_name_or_path", f"{root}/sd21",
                   "--image_encoder_p_path", f"{root}/dino16"],
    }


S1_LATENTS = np.random.default_rng(4).standard_normal((3, 16)).astype(
    np.float32)
SAMPLER = ["--num_inference_steps", "2", "--num_images_per_prompt", "2",
           "--scheduler", "ddim", "--img_width", "64", "--img_height", "64"]
# cli -> (port module, JAX module path, json, extra flags of both)
CLIS = {
    "stage1": (stage1_batchtest, "pcdms_tpu.cli.stage1_batchtest",
               "test_pairs.json", ["--num_inference_steps", "1"]),
    "stage2_test": (stage2_batchtest, "pcdms_tpu.cli.stage2_batchtest",
                    "test_pairs.json", SAMPLER + ["--prior_embeds_dir",
                                                  "{root}/prior"]),
    "stage2_train": (stage2_batchtest, "pcdms_tpu.cli.stage2_batchtest",
                     "train_pairs.json", SAMPLER),
    "stage3": (stage3_batchtest, "pcdms_tpu.cli.stage3_batchtest",
               "test_pairs.json", SAMPLER + ["--gen_dir", "{root}/gen"]),
}


def _patch_both(mp):
    """One device for the JAX CLI; the samplers and the CLIP encoder in f32
    with the VAE at its posterior mean on both sides; stage 1 from one
    injected draw (the CLIs' own defaults are bf16 and their own
    generators, where the two frameworks differ by design)."""
    mp.setattr(j_common, "default_mesh",
               lambda: make_mesh(jax.devices()[:1]))
    for j, tm, name in ((j_stage2, t_stage2, "stage2_generate"),
                        (j_stage3, t_stage3, "stage3_generate")):
        for module, dtype in ((j, jnp.float32), (tm, torch.float32)):
            mp.setattr(module, name, functools.partial(
                getattr(module, name), deterministic_vae=True,
                compute_dtype=dtype))
    for module in (j_stage1, t_stage1):
        mp.setattr(module, "stage1_generate", functools.partial(
            module.stage1_generate, latents=S1_LATENTS))
    for module, dtype in ((j_encoders, jnp.float32),
                          (t_encoders, torch.float32)):
        mp.setattr(module, "clip_image_embed", functools.partial(
            module.clip_image_embed, compute_dtype=dtype))


def _outputs(out, ext):
    if ext == ".npy":
        return {s: np.load(os.path.join(out, f"{s}.npy")) for s in STEMS}
    return {s: np.asarray(Image.open(os.path.join(out, f"{s}.png")),
                          np.int32) for s in STEMS}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_matches_jax_on_loaded_weights(cli, dataset, files, tmp_path):
    import importlib
    port, j_path, json_name, extra = CLIS[cli]
    flags = files[cli.split("_")[0]]
    extra = [f.format(root=dataset) for f in extra]
    outs = {k: str(tmp_path / k) for k in ("jax", "port")}
    base = ["--json_path", os.path.join(dataset, json_name),
            "--image_root_path", dataset, "--batch_size", "3",
            "--tiny_config"] + extra + flags
    with pytest.MonkeyPatch.context() as mp:
        _patch_both(mp)
        importlib.import_module(j_path).main(
            base + ["--save_path", outs["jax"]])
        written = port.main(base + ["--save_path", outs["port"],
                                    "--device", "cpu"])
    ext = ".npy" if cli == "stage1" else ".png"
    assert [os.path.basename(p) for p in written] == [s + ext for s in STEMS]
    want, got = _outputs(outs["jax"], ext), _outputs(outs["port"], ext)
    for stem in STEMS:
        assert got[stem].shape == want[stem].shape and got[stem].std() > 0
        if ext == ".npy":
            np.testing.assert_allclose(got[stem], want[stem], **TOL)
        else:
            assert np.abs(got[stem] - want[stem]).max() <= 3, stem


def test_cli_refuses_missing_weight_files(dataset):
    """Without --random_init or --train_ckpt_dir every file the loading
    reads is required; train mode also needs the CLIP dir."""
    base = ["--json_path", os.path.join(dataset, "train_pairs.json"),
            "--save_path", "out", "--image_root_path", dataset]
    with pytest.raises(SystemExit, match="--weights_name, "
                       "--pretrained_model_name_or_path, "
                       "--image_encoder_p_path required"):
        stage2_batchtest.check_supported(stage2_batchtest.parse_args(base))
    args = stage2_batchtest.parse_args(base + [
        "--weights_name", "w", "--pretrained_model_name_or_path", "p",
        "--image_encoder_p_path", "d", "--tiny_config"])
    stage2_batchtest.check_supported(args)
    with pytest.raises(SystemExit, match="--image_encoder_g_path"):
        stage2_batchtest.build_models(args, True, "cpu")


def test_trainer_grows_conv_in_from_a_4_channel_unet(weights, tmp_path):
    """SD-2.1's 4-channel UNet: conv_in grows to 9 inputs with zeros, the
    file's 4 channels kept bit for bit (the JAX CLI's ``_grow_conv_in``
    gives the same weight), a seeded class embedding is added, the VAE is
    the file's, and the trainer takes a step."""
    cfg4 = dataclasses.replace(TINY.unet2(False), in_channels=4)
    jparams, _ = unet_pair(cfg4, 30)
    sd4 = from_jax.unet_state_dict(jax.tree.map(np.asarray, jparams))
    root = str(tmp_path / "sd21")
    _save(f"{root}/unet/diffusion_pytorch_model.safetensors", _tensors(sd4))
    _save(f"{root}/vae/diffusion_pytorch_model.bin", _tensors(weights["vae"]))
    argv = ["--tiny_config", "--synthetic_data", "--device", "cpu",
            "--pretrained_model_name_or_path", root, "--output_dir",
            str(tmp_path / "out"), "--img_height", "64", "--img_width", "64",
            "--train_batch_size", "2", "--lr_warmup_steps", "1"]
    args = stage2_train.parse_args(argv)
    stage2_train.check_supported(args)
    cfg, trainable, vae, _, _, _ = stage2_train.build_models(args, "cpu")
    assert cfg.in_channels == 9 and cfg.class_embed_proj_dim == 16
    w = trainable["unet"].conv_in.weight.detach()
    assert w.shape[1] == 9
    np.testing.assert_array_equal(w[:, :4].numpy(), sd4["conv_in.weight"])
    assert not w[:, 4:].any()
    grown = j_train._grow_conv_in(
        j_convert_unet(sd4), TINY.unet2(True), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(
        w.numpy(), from_jax.unet_state_dict(grown)["conv_in.weight"])
    state = trainable["unet"].state_dict()
    for key, value in sd4.items():
        if key != "conv_in.weight":
            np.testing.assert_array_equal(state[key].numpy(), value, key)
    emb = {k: v for k, v in state.items() if k.startswith("class_embedding")}
    assert sorted(emb) == ["class_embedding.linear_1.bias",
                           "class_embedding.linear_1.weight",
                           "class_embedding.linear_2.bias",
                           "class_embedding.linear_2.weight"]
    again = stage2_train.build_models(args, "cpu")[1]["unet"].state_dict()
    for key in emb:                                  # seeded
        assert torch.equal(again[key], emb[key])
    for key, value in weights["vae"].items():
        np.testing.assert_array_equal(vae.state_dict()[key].numpy(), value)
    state = stage2_train.main(argv + ["--max_train_steps", "1"])
    assert state.step == 1
