"""The stage-1 and stage-3 batch tests on the CPU: the port's CLIs against
the JAX package's at the tiny configs with the same weights (the JAX CLI's
random init, carried to the port as a training checkpoint and a frozen
bundle), on a DeepFashion-layout root with pose ``.txt`` files and
stage-2 PNGs; and the pieces they add (``pose/keypoints``,
``cosine_similarity``, ``Stage3Dataset.gen_path``) against the JAX
package's.

Stage 1: both CLIs run one UnCLIP step from the same injected initial
latents (the step's noise is scaled by the 1e-10 variance floor) and both
CLIP encoders compute in f32 (the CLIs' default is bf16, where the two
frameworks round at different points), both by monkeypatching in this test
only; the ``.npy`` files agree at the module bar (atol 1e-4, rtol 1e-3) and
the mean cosine in ``a_results.txt`` within 1e-4. Stage 3: both samplers
compute in f32 with the VAE at its posterior mean (each CLI otherwise
samples it from its own generator); the PNGs and the ``--grid_output``
grids agree within 3 uint8 levels, the bar of tests/test_batchtest_cli.py,
and ``--device_select`` writes what host selection writes."""

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
import pcdms_tpu.pipelines.stage1_prior as j_stage1
import pcdms_tpu.pipelines.stage3_refine as j_stage3
import pcdms_tpu.train.encoders as j_encoders
from pcdms_tpu.data.datasets import PairList as JPairList
from pcdms_tpu.data.datasets import Stage3Dataset as JStage3Dataset
from pcdms_tpu.eval.metrics import cosine_similarity as j_cosine
from pcdms_tpu.models.projections import image_proj_mlp_init
from pcdms_tpu.models.prior_transformer import prior_init
from pcdms_tpu.models.unet2d import unet_init
from pcdms_tpu.models.vae import vae_init
from pcdms_tpu.models.vit import vit_init
from pcdms_tpu.parallel.mesh import make_mesh
from pcdms_tpu.pose import keypoints as j_keypoints

import pcdms_tpu_torch.pipelines.stage1_prior as t_stage1
import pcdms_tpu_torch.pipelines.stage3_refine as t_stage3
import pcdms_tpu_torch.train.encoders as t_encoders
from pcdms_tpu_torch.cli import stage1_batchtest, stage3_batchtest
from pcdms_tpu_torch.compat.from_jax import (
    image_proj_state_dict, load_numpy_state_dict, prior_state_dict,
    unet_state_dict, vae_state_dict, vit_state_dict,
)
from pcdms_tpu_torch.data.datasets import PairList, Stage3Dataset
from pcdms_tpu_torch.eval.metrics import cosine_similarity
from pcdms_tpu_torch.models.projections import ImageProjModel
from pcdms_tpu_torch.models.prior_transformer import (
    PriorConfig, PriorTransformer,
)
from pcdms_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig
from pcdms_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from pcdms_tpu_torch.models.vit import ViTConfig, VisionTransformer
from pcdms_tpu_torch.pose import keypoints
from pcdms_tpu_torch.train.checkpoint import save_checkpoint
from pcdms_tpu_torch.train.common import TrainConfig, init_train_state
from pcdms_tpu_torch.train.frozen import save_frozen

from _torch_common import TINY, TOL, port_config

NAMES = ["im0", "im1", "im2"]
STEMS = [f"{NAMES[i]}_to_{NAMES[(i + 1) % 3]}" for i in range(3)]
SEED = 42


def _images(seed, count, shape=(64, 64, 3)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (count,) + shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def test_pose_keypoints_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    coords = rng.uniform(0, 1, 36).astype(np.float32)
    path, j_path = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    keypoints.write_pose_txt(path, coords)
    j_keypoints.write_pose_txt(j_path, coords)
    assert open(path).read() == open(j_path).read()
    got = keypoints.read_pose_txt(path)
    assert got.dtype == np.float32 and got.shape == (36,)
    np.testing.assert_array_equal(got, j_keypoints.read_pose_txt(path))
    kpts = rng.uniform(0, 512, (2, 17, 2)).astype(np.float32)
    scores = rng.uniform(0, 1, (2, 17)).astype(np.float32)
    scores[0, 5] = 0.1                          # no neck in the first
    for g, w in zip(keypoints.coco_to_openpose(kpts, scores),
                    j_keypoints.coco_to_openpose(kpts, scores)):
        np.testing.assert_array_equal(g, w)
    k18 = keypoints.coco_to_openpose(kpts, scores)[0][1]
    np.testing.assert_array_equal(keypoints.flatten_keypoints(k18),
                                  j_keypoints.flatten_keypoints(k18))
    assert keypoints.OPENPOSE_JOINTS == j_keypoints.OPENPOSE_JOINTS


def test_cosine_similarity_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((5, 16)).astype(np.float32)
    b = rng.standard_normal((5, 16)).astype(np.float32)
    b[0] = 0.0                                  # the 1e-12 floor
    got = cosine_similarity(a, b)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, j_cosine(a, b))


def test_stage3_dataset_paths_match_jax():
    pairs = [{"source_image": f"x/train_all_png/a{i}.jpg",
              "target_image": f"x/train_all_png/b{i}.jpg"} for i in range(3)]
    got = Stage3Dataset(PairList(pairs, "/r"), "/gen", size=(64, 64))
    want = JStage3Dataset(JPairList(pairs, "/r"), "/gen", size=(64, 64))
    assert len(got) == len(want) == 3
    assert [got.gen_path(p) for p in pairs] == [want.gen_path(p)
                                                 for p in pairs]
    # the training examples are ported (tests/test_torch_data.py holds them
    # against JAX): both read the pair's images, absent here
    for ds in (got, want):
        with pytest.raises(FileNotFoundError):
            ds._example(0, np.random.default_rng(0))


@pytest.mark.parametrize("cli,flag", [
    (stage1_batchtest, "--weights_name"),
    (stage1_batchtest, "--image_encoder_path"),
    (stage3_batchtest, "--weights_name"),
    (stage3_batchtest, "--pretrained_model_name_or_path"),
    (stage3_batchtest, "--image_encoder_p_path")])
def test_pretrained_flags_raise(cli, flag):
    base = ["--json_path", "p.json", "--save_path", "out"]
    if cli is stage3_batchtest:
        base += ["--gen_dir", "gen"]
    # pretrained loading is ported (tests/test_torch_load.py): without
    # --random_init or --train_ckpt_dir each file it reads is required
    with pytest.raises(SystemExit, match=f"{flag}.* required"):
        cli.check_supported(cli.parse_args(base))
    with pytest.raises(SystemExit) as refused:
        cli.check_supported(cli.parse_args(base + [flag, "x"]))
    assert flag not in str(refused.value)
    cli.check_supported(cli.parse_args(base + ["--random_init", flag, "x"]))
    with pytest.raises(SystemExit, match="--frozen_dir"):
        cli.check_supported(cli.parse_args(base + ["--train_ckpt_dir", "c"]))


# ---------------------------------------------------------------------------
# the two CLIs end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """3 images in the DeepFashion layout with their normalised pose
    ``.txt`` files, 3 stage-2 PNGs and a test pair list."""
    root = tmp_path_factory.mktemp("deepfashion")
    for sub in ("train_all_png", "normalized_pose_txt", "gen"):
        (root / sub).mkdir()
    imgs = _images(0, 3)
    rng = np.random.default_rng(3)
    for i, stem in enumerate(NAMES):
        Image.fromarray(imgs[i]).save(root / "train_all_png" / f"{stem}.png")
        keypoints.write_pose_txt(
            str(root / "normalized_pose_txt" / f"{stem}.txt"),
            rng.uniform(0, 1, 36))
    for i, stem in enumerate(STEMS):
        Image.fromarray(_images(10 + i, 1)[0]).save(root / "gen"
                                                    / f"{stem}.png")
    pairs = [{"source_image": f"train_all_png/{NAMES[i]}.jpg",
              "target_image": f"train_all_png/{NAMES[(i + 1) % 3]}.jpg"}
             for i in range(3)]
    (root / "test_pairs.json").write_text(json.dumps(pairs))
    return str(root)


def _vit(name, p):
    cfg = getattr(TINY, name)
    return load_numpy_state_dict(VisionTransformer(port_config(cfg,
                                                               ViTConfig)),
                                 vit_state_dict(p, cfg))


def _save_port_weights(directory, trainable, frozen):
    """A port training checkpoint and frozen bundle; the CLI flags that
    load them."""
    ckpt, bundle = (os.path.join(directory, d) for d in ("ckpt", "frozen"))
    save_checkpoint(ckpt, 1, init_train_state(trainable, TrainConfig()))
    save_frozen(bundle, frozen)
    return ["--train_ckpt_dir", ckpt, "--frozen_dir", bundle]


def _stage1_weights(directory):
    """The JAX stage-1 CLI's --random_init --tiny_config weights (its keys:
    pcdms_tpu/cli/stage1_batchtest.py, main) as port files."""
    key = jax.random.PRNGKey(SEED)
    prior = jax.tree.map(np.asarray, prior_init(key, TINY.prior))
    clip = jax.tree.map(np.asarray, vit_init(key, TINY.clip))
    model = load_numpy_state_dict(
        PriorTransformer(port_config(TINY.prior, PriorConfig)),
        prior_state_dict(prior))
    return _save_port_weights(directory, {"prior": model},
                              {"clip": _vit("clip", clip)})


def _stage3_weights(directory):
    """The JAX stage-3 CLI's --random_init --tiny_config weights (its keys:
    pcdms_tpu/cli/stage3_batchtest.py, main) as port files."""
    ks = jax.random.split(jax.random.PRNGKey(SEED), 4)
    p = jax.tree.map(np.asarray, {
        "unet": unet_init(ks[0], TINY.unet3),
        "image_proj": image_proj_mlp_init(ks[1], **TINY.image_proj_kwargs),
        "vae": vae_init(ks[2], TINY.vae),
        "dino": vit_init(ks[3], TINY.dino)})
    trainable = {
        "unet": load_numpy_state_dict(
            UNet2DConditionModel(port_config(TINY.unet3, UNetConfig)),
            unet_state_dict(p["unet"])),
        "image_proj": load_numpy_state_dict(
            ImageProjModel(**TINY.image_proj_kwargs),
            image_proj_state_dict(p["image_proj"]))}
    frozen = {"vae": load_numpy_state_dict(
        AutoencoderKL(port_config(TINY.vae, VAEConfig)),
        vae_state_dict(p["vae"])), "dino": _vit("dino", p["dino"])}
    return _save_port_weights(directory, trainable, frozen)


def _argv(root, out, extra=()):
    return ["--json_path", os.path.join(root, "test_pairs.json"),
            "--image_root_path", root, "--save_path", out,
            "--batch_size", "3", "--tiny_config"] + list(extra)


# the one injected initial draw of the stage-1 runs (3 pairs, E = 16)
S1_LATENTS = np.random.default_rng(4).standard_normal((3, 16)).astype(
    np.float32)


@pytest.fixture(scope="module")
def stage1_runs(dataset, tmp_path_factory):
    """(JAX output dir, port output dir, written .npy paths)."""
    d = str(tmp_path_factory.mktemp("stage1"))
    flags = _stage1_weights(d)
    out = {name: os.path.join(d, name) for name in ("jax", "port")}
    steps = ["--num_inference_steps", "1"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_common, "default_mesh",
                   lambda: make_mesh(jax.devices()[:1]))
        mp.setattr(j_stage1, "stage1_generate", functools.partial(
            j_stage1.stage1_generate, latents=S1_LATENTS))
        mp.setattr(t_stage1, "stage1_generate", functools.partial(
            t_stage1.stage1_generate, latents=S1_LATENTS))
        mp.setattr(j_encoders, "clip_image_embed", functools.partial(
            j_encoders.clip_image_embed, compute_dtype=jnp.float32))
        mp.setattr(t_encoders, "clip_image_embed", functools.partial(
            t_encoders.clip_image_embed, compute_dtype=torch.float32))
        from pcdms_tpu.cli.stage1_batchtest import main as j_main
        j_main(_argv(dataset, out["jax"], steps + ["--random_init"]))
        written = stage1_batchtest.main(_argv(
            dataset, out["port"], steps + flags + ["--device", "cpu"]))
    return out["jax"], out["port"], written


def _cosine(out):
    with open(os.path.join(out, "a_results.txt")) as f:
        line, = f.read().splitlines()
    name, value = line.split()
    assert name == "None"
    return float(value)


def test_stage1_cli_matches_jax(stage1_runs):
    j_out, t_out, written = stage1_runs
    assert [os.path.basename(p) for p in written] == [
        f"{s}.npy" for s in STEMS]
    for stem in STEMS:
        got = np.load(os.path.join(t_out, f"{stem}.npy"))
        want = np.load(os.path.join(j_out, f"{stem}.npy"))
        assert got.shape == want.shape == (1, 16) and got.std() > 0
        np.testing.assert_allclose(got, want, **TOL, err_msg=stem)
    assert abs(_cosine(t_out) - _cosine(j_out)) <= 1e-4


def _deterministic_f32(module, dtype):
    return functools.partial(module.stage3_generate, deterministic_vae=True,
                             compute_dtype=dtype)


def _read(out, prefix=""):
    return {stem: np.asarray(Image.open(
        os.path.join(out, f"{prefix}{stem}.png")), np.int32)
        for stem in STEMS}


STAGE3_FLAGS = ["--gen_dir", None, "--img_width", "64", "--img_height",
                "64", "--num_inference_steps", "2",
                "--num_images_per_prompt", "2", "--scheduler", "ddim",
                "--grid_output"]


def _stage3_flags(root):
    flags = list(STAGE3_FLAGS)
    flags[1] = os.path.join(root, "gen")
    return flags


@pytest.fixture(scope="module")
def stage3_runs(dataset, tmp_path_factory):
    """{"jax" | "port": (PNGs, grids)} and the port's weight flags."""
    d = str(tmp_path_factory.mktemp("stage3"))
    flags = _stage3_weights(d)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_common, "default_mesh",
                   lambda: make_mesh(jax.devices()[:1]))
        mp.setattr(j_stage3, "stage3_generate",
                   _deterministic_f32(j_stage3, jnp.float32))
        mp.setattr(t_stage3, "stage3_generate",
                   _deterministic_f32(t_stage3, torch.float32))
        from pcdms_tpu.cli.stage3_batchtest import main as j_main
        for name, extra in (("jax", ["--random_init"]),
                            ("port", flags + ["--device", "cpu"])):
            out = os.path.join(d, name)
            argv = _argv(dataset, out, _stage3_flags(dataset) + extra)
            written = (j_main if name == "jax" else stage3_batchtest.main)(
                argv)
            if name == "port":
                assert [os.path.basename(p) for p in written] == [
                    f"{s}.png" for s in STEMS]
            runs[name] = (_read(out), _read(out, "grid_"))
    return runs, flags


def test_stage3_cli_matches_jax(stage3_runs):
    runs, _ = stage3_runs
    (want, want_grid), (got, got_grid) = runs["jax"], runs["port"]
    for stem in STEMS:
        assert got[stem].shape == want[stem].shape == (64, 64, 3)
        assert got[stem].std() > 0
        assert np.abs(got[stem] - want[stem]).max() <= 3, stem
        assert got_grid[stem].shape == (64, 256, 3)
        assert np.abs(got_grid[stem] - want_grid[stem]).max() <= 3, stem


def test_stage3_device_select_matches_host(stage3_runs, dataset, tmp_path,
                                           monkeypatch):
    runs, flags = stage3_runs
    monkeypatch.setattr(t_stage3, "stage3_generate",
                        _deterministic_f32(t_stage3, torch.float32))
    out = str(tmp_path / "out")
    stage3_batchtest.main(_argv(dataset, out, _stage3_flags(dataset) + flags
                                + ["--device", "cpu", "--device_select"]))
    got, want = _read(out), runs["port"][0]
    for stem in STEMS:
        np.testing.assert_array_equal(got[stem], want[stem])
