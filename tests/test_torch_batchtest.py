"""The stage-2 batch test on the CPU: the port's pieces against the JAX
package's (on-device SSIM at 1e-6 and the host SSIM at 1e-5; best-of-N
selection, latents, preprocessing and the pair list exactly), then the two
CLIs end to end at the tiny config with the same weights: the JAX CLI's
random init, carried to the port as a training checkpoint and a frozen
bundle. Both CLIs sample the VAE posterior from their own generators, so
both are run with ``deterministic_vae=True``, and both samplers compute in
f32 (in bf16 the two frameworks round at different points: up to 5 levels
apart). The PNGs agree within 3 uint8 levels, the JAX suite's own bar for
this CLI (tests/test_batchtest_cli.py); ``--sequential`` and
``--device_select`` are held to the default run."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import pcdms_tpu.cli.common as j_common
import pcdms_tpu.pipelines.stage2_inpaint as j_pipeline
from pcdms_tpu.data import preprocess as j_pre
from pcdms_tpu.data.datasets import PairList as JPairList
from pcdms_tpu.eval.metrics import compare_ssim as j_compare_ssim
from pcdms_tpu.eval.ssim_jax import ssim_jax
from pcdms_tpu.models.projections import (
    image_proj_mlp_init, pose_cond_embedding_init,
)
from pcdms_tpu.models.unet2d import unet_init
from pcdms_tpu.models.vae import vae_init
from pcdms_tpu.models.vit import vit_init
from pcdms_tpu.parallel.mesh import make_mesh

import pcdms_tpu_torch.pipelines.stage2_inpaint as t_pipeline
from pcdms_tpu_torch.cli import common as t_common
from pcdms_tpu_torch.cli.stage2_batchtest import main as t_main
from pcdms_tpu_torch.cli.stage2_batchtest import parse_args, check_supported
from pcdms_tpu_torch.compat.from_jax import (
    image_proj_state_dict, load_numpy_state_dict, pose_proj_state_dict,
    unet_state_dict, vae_state_dict, vit_state_dict,
)
from pcdms_tpu_torch.data import preprocess as t_pre
from pcdms_tpu_torch.data.datasets import PairList
from pcdms_tpu_torch.eval.metrics import compare_ssim
from pcdms_tpu_torch.eval.ssim import ssim
from pcdms_tpu_torch.models.projections import (
    ImageProjModel, PoseCondEmbedding,
)
from pcdms_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig
from pcdms_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from pcdms_tpu_torch.models.vit import ViTConfig, VisionTransformer
from pcdms_tpu_torch.train.checkpoint import save_checkpoint
from pcdms_tpu_torch.train.common import TrainConfig, init_train_state
from pcdms_tpu_torch.train.frozen import save_frozen

from _torch_common import TINY, n, port_config, t

NAMES = ["im0", "im1", "im2"]
PAIR_STEMS = [("im0", "im1"), ("im1", "im2"), ("im2", "im0")]
SEED = 42


def _images(seed, count, shape=(64, 64, 3)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (count,) + shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def test_ssim_matches_jax_and_host():
    a = _images(1, 3, (40, 48, 3)).astype(np.float32) / 255.0
    b = np.clip(a + np.random.default_rng(2).normal(0, 0.1, a.shape), 0,
                1).astype(np.float32)
    got = n(ssim(t(a), t(b)))
    np.testing.assert_allclose(got, n(ssim_jax(a, b)), atol=1e-6, rtol=0)
    host = [compare_ssim(x, y) for x, y in zip(a, b)]
    np.testing.assert_allclose(got, host, atol=1e-5, rtol=0)
    assert host == [j_compare_ssim(x, y) for x, y in zip(a, b)]


def test_device_select_best_matches_jax():
    rng = np.random.default_rng(3)
    s, items = 3, 2
    images = rng.uniform(-1, 1, (s * items, 32, 64, 3)).astype(np.float32)
    gt = _images(4, items, (32, 32, 3))
    # make one candidate per item close to its target
    for j in range(items):
        images[s - 1 - j][:, 32:] = gt[j] / 127.5 - 1.0 + 0.01
    got_u8, got_idx = t_common.device_select_best(t(images), gt, s)
    want_u8, want_idx = j_common.device_select_best(images, gt, s)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_u8.numpy(), np.asarray(want_u8))
    np.testing.assert_array_equal(
        t_common.device_uint8(t(images)).numpy(),
        np.asarray(j_common.device_uint8(images)))


def test_per_item_latents_match_jax():
    np.testing.assert_array_equal(
        t_common.per_item_latents(7, [3, 4, 4], 2, (4, 8, 4)),
        j_common.per_item_latents(7, [3, 4, 4], 2, (4, 8, 4)))


def test_preprocess_matches_jax(tmp_path):
    arr = _images(5, 1, (50, 70, 3))[0]
    path = str(tmp_path / "x.png")
    Image.fromarray(arr).save(path)
    img, jimg = t_pre.load_image(path, (64, 48)), j_pre.load_image(path,
                                                                   (64, 48))
    np.testing.assert_array_equal(np.asarray(img), np.asarray(jimg))
    np.testing.assert_array_equal(t_pre.to_neg1_1(img), j_pre.to_neg1_1(img))
    for x in (img, arr):
        np.testing.assert_array_equal(t_pre.clip_preprocess(x),
                                      j_pre.clip_preprocess(x))
    np.testing.assert_array_equal(
        np.asarray(t_pre.make_side_by_side(img, t_pre.black_like(img))),
        np.asarray(j_pre.make_side_by_side(img, j_pre.black_like(img))))


def test_pair_list_matches_jax():
    pairs = [{"source_image": f"x/train_all_png/a{i}.jpg",
              "target_image": f"x/train_all_png/b{i}.jpg"} for i in range(5)]
    got, want = PairList(pairs, "/r"), JPairList(pairs, "/r")
    for name in ("x/train_all_png/a1.jpg", "x/train_all_png/b3.png"):
        for fn in ("image_path", "pose_txt_path", "pose_img_path"):
            assert getattr(got, fn)(name) == getattr(want, fn)(name)
    assert got.shard(1, 2).pairs == want.shard(1, 2).pairs
    assert len(got.shard(0, 1)) == 5


def test_pretrained_flags_raise():
    """Pretrained loading is ported (tests/test_torch_load.py): the check
    exits only where the JAX CLI cannot go on, with no weight files and no
    other source, or --train_ckpt_dir without --frozen_dir; --random_init
    wins over the file flags, as in the JAX CLI."""
    base = ["--json_path", "p.json", "--save_path", "out"]
    with pytest.raises(SystemExit, match="--weights_name, --pretrained_model"
                       "_name_or_path, --image_encoder_p_path required"):
        check_supported(parse_args(base))
    with pytest.raises(SystemExit, match="--pretrained_model_name_or_path "
                       "required"):
        check_supported(parse_args(base + ["--weights_name", "w.pt",
                                           "--image_encoder_p_path", "d"]))
    with pytest.raises(SystemExit, match="--frozen_dir"):
        check_supported(parse_args(base + ["--train_ckpt_dir", "c"]))
    for extra in (["--random_init", "--weights_name", "w.pt"],
                  ["--random_init", "--image_encoder_p_path", "d"],
                  ["--weights_name", "w.pt", "--pretrained_model_name_or_"
                   "path", "sd", "--image_encoder_p_path", "d"]):
        check_supported(parse_args(base + extra))
    # encoder propagation is ported: the flag passes (run against the JAX
    # CLI in test_cli_matches_jax[enc_prop])
    check_supported(parse_args(base + ["--random_init",
                                       "--encoder_cache_interval", "2"]))


# ---------------------------------------------------------------------------
# the two CLIs end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The DeepFashion layout of tests/test_batchtest_cli.py: 3 images and
    their pose renders, a test and a train pair list."""
    root = tmp_path_factory.mktemp("deepfashion")
    img_dir, pose_dir = root / "train_all_png", root / "openpose_all_img"
    for d in (img_dir, pose_dir):
        d.mkdir()
    imgs, poses = _images(0, 3), _images(1, 3)
    for i, stem in enumerate(NAMES):
        Image.fromarray(imgs[i]).save(img_dir / f"{stem}.png")
        Image.fromarray(poses[i]).save(pose_dir / f"{stem}_pose.jpg")
    pairs = [{"source_image": f"train_all_png/{NAMES[i]}.jpg",
              "target_image": f"train_all_png/{NAMES[(i + 1) % 3]}.jpg"}
             for i in range(3)]
    for name in ("test_pairs.json", "train_pairs.json"):
        (root / name).write_text(json.dumps(pairs))
    return str(root)


def _jax_cli_params(simple_variant: bool):
    """The JAX CLI's --random_init --tiny_config weights, drawn with its
    keys (pcdms_tpu/cli/stage2_batchtest.py, main)."""
    ks = jax.random.split(jax.random.PRNGKey(SEED), 5)
    return {
        "unet": unet_init(ks[0], TINY.unet2(not simple_variant)),
        "image_proj": image_proj_mlp_init(ks[1], **TINY.image_proj_kwargs),
        "pose_proj": pose_cond_embedding_init(ks[2], **TINY.pose_proj_kwargs),
        "vae": vae_init(ks[3], TINY.vae),
        "dino": vit_init(ks[4], TINY.dino),
        "clip": vit_init(jax.random.PRNGKey(SEED), TINY.clip),
    }


def _port_weights(directory, simple_variant: bool):
    """The JAX CLI's weights as a port training checkpoint and frozen
    bundle; returns the CLI flags that load them."""
    p = jax.tree.map(np.asarray, _jax_cli_params(simple_variant))
    unet = UNet2DConditionModel(port_config(TINY.unet2(not simple_variant),
                                            UNetConfig))
    trainable = {
        "unet": load_numpy_state_dict(unet, unet_state_dict(p["unet"])),
        "image_proj": load_numpy_state_dict(
            ImageProjModel(**TINY.image_proj_kwargs),
            image_proj_state_dict(p["image_proj"])),
        "pose_proj": load_numpy_state_dict(
            PoseCondEmbedding(**TINY.pose_proj_kwargs),
            pose_proj_state_dict(p["pose_proj"])),
    }
    frozen = {"vae": load_numpy_state_dict(
        AutoencoderKL(port_config(TINY.vae, VAEConfig)),
        vae_state_dict(p["vae"]))}
    for name in ("dino", "clip"):
        cfg = getattr(TINY, name)
        frozen[name] = load_numpy_state_dict(
            VisionTransformer(port_config(cfg, ViTConfig)),
            vit_state_dict(p[name], cfg))
    ckpt, bundle = os.path.join(directory, "ckpt"), os.path.join(
        directory, "frozen")
    save_checkpoint(ckpt, 1, init_train_state(trainable, TrainConfig()))
    save_frozen(bundle, frozen)
    return ["--train_ckpt_dir", ckpt, "--frozen_dir", bundle]


def _argv(root, json_name, out, simple_variant, extra=()):
    argv = ["--json_path", os.path.join(root, json_name),
            "--image_root_path", root, "--save_path", out,
            "--img_width", "64", "--img_height", "64",
            "--num_inference_steps", "2", "--num_images_per_prompt", "2",
            "--scheduler", "ddim", "--batch_size", "3", "--tiny_config"]
    return argv + (["--simple_variant"] if simple_variant else []) + list(
        extra)


def _read(out):
    return {f"{s}_to_{tg}": np.asarray(Image.open(
        os.path.join(out, f"{s}_to_{tg}.png")), np.int32)
        for s, tg in PAIR_STEMS}


def _deterministic_vae(module, dtype):
    return functools.partial(module.stage2_generate, deterministic_vae=True,
                             compute_dtype=dtype)


# (json name, --simple_variant, flags of both CLIs): the JAX suite's tiny
# run, train mode (target CLIP embeddings, class-embedding UNet), and the
# tiny run with encoder propagation (step 0 full, step 1 decode-only)
RUNS = {"simple": ("test_pairs.json", True, []),
        "train": ("train_pairs.json", False, []),
        "enc_prop": ("test_pairs.json", True,
                     ["--encoder_cache_interval", "2"])}


@pytest.fixture(scope="module")
def cli_runs(dataset, tmp_path_factory):
    """{run: (JAX PNGs, port PNGs, port flags)}, each CLI run once."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_common, "default_mesh",
                   lambda: make_mesh(jax.devices()[:1]))
        mp.setattr(j_pipeline, "stage2_generate",
                   _deterministic_vae(j_pipeline, jnp.float32))
        mp.setattr(t_pipeline, "stage2_generate",
                   _deterministic_vae(t_pipeline, torch.float32))
        from pcdms_tpu.cli.stage2_batchtest import main as j_main
        for run, (json_name, simple, both) in RUNS.items():
            d = str(tmp_path_factory.mktemp(f"cli_{run}"))
            flags = _port_weights(d, simple)
            j_out, t_out = os.path.join(d, "jax"), os.path.join(d, "port")
            j_main(_argv(dataset, json_name, j_out, simple,
                         ["--random_init"] + both))
            written = t_main(_argv(dataset, json_name, t_out, simple,
                                   flags + both + ["--device", "cpu"]))
            assert len(written) == 3
            out[run] = (_read(j_out), _read(t_out), flags)
    return out


@pytest.mark.parametrize("run", sorted(RUNS))
def test_cli_matches_jax(cli_runs, run):
    want, got, _ = cli_runs[run]
    for key in want:
        assert got[key].shape == want[key].shape == (64, 64, 3)
        assert got[key].std() > 0                 # not a constant canvas
        assert np.abs(got[key] - want[key]).max() <= 3, key
    if run == "enc_prop":      # the flag reached the sampler
        exact = cli_runs["simple"][1]
        assert any(not np.array_equal(got[k], exact[k]) for k in got)


@pytest.mark.parametrize("mode", ["--sequential", "--device_select"])
def test_cli_orderings_and_device_select_match(cli_runs, dataset, tmp_path,
                                               monkeypatch, mode):
    """--sequential (batch 1, so the deferred finish runs) writes the same
    bytes as the default; --device_select picks what the host picks."""
    monkeypatch.setattr(t_pipeline, "stage2_generate",
                        _deterministic_vae(t_pipeline, torch.float32))
    _, want, flags = cli_runs["simple"]
    out = str(tmp_path / "out")
    extra = flags + ["--device", "cpu", mode]
    if mode == "--sequential":
        extra += ["--batch_size", "1"]
    t_main(_argv(dataset, "test_pairs.json", out, True, extra))
    got = _read(out)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
