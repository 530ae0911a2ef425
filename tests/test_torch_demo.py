"""The single-image demo's port (``pcdms_tpu_torch/cli/demo.py``,
``examples/make_demo_notebook_torch.py``, ``examples/demo_torch.ipynb``)
against the JAX demo (``examples/demo.py``), on the CPU at the tiny
configurations.

* ``load_pose_canvas`` (a keypoint ``.txt``, a rendered image, None), the
  [source | black] canvas, the pose canvas and DINOv2's input equal the
  JAX demo's exactly.
* The demo's image against the JAX ``stage2_generate`` (the JAX demo's one
  jitted call) on the same inputs: the port's seeded modules carried to
  the JAX layouts (``pcdms_tpu/compat/torch_convert.py``), the latents
  injected, the VAE's posterior mean, f32, DDIM 3 steps, CFG 2.0; atol
  1e-4 / rtol 1e-3 on the decoded images. (The JAX demo's own test,
  ``tests/test_demo.py``, is marked slow.)
* The missing-flags ``SystemExit``, a pre-rendered pose image, and a
  simple-variant monolithic checkpoint (no ``class_embedding``) with the
  VAE and DINOv2 files saved from the seeded modules: its PNG byte-identical
  to ``--random_init``'s.
* The notebook's code cells, read with ``json``, run at the tiny geometry
  on the CPU; ``make_demo_notebook_torch.build()`` reproduces the committed
  cells where ``nbformat`` imports.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pcdms_tpu.cli.common import tiny_configs as j_tiny_configs
from pcdms_tpu.compat.torch_convert import (
    convert_dinov2, convert_image_proj, convert_pose_proj, convert_unet,
    convert_vae,
)
from pcdms_tpu.data import preprocess as j_pre
from pcdms_tpu.pipelines.stage2_inpaint import stage2_generate as j_stage2
from pcdms_tpu.train.encoders import dino_features as j_dino_features

from pcdms_tpu_torch.cli import demo

from _torch_common import TOL, one_thread

ROOT = os.path.join(os.path.dirname(__file__), "..")
SIZE = 64


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def j_demo():
    return _load(os.path.join(ROOT, "examples", "demo.py"), "j_demo")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo_inputs")
    rng = np.random.default_rng(0)
    paths = {"source": root / "person.png", "pose_img": root / "pose.png",
             "pose_txt": root / "pose.txt"}
    Image.fromarray(rng.integers(0, 255, (96, 80, 3), dtype=np.uint8)).save(
        paths["source"])
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(
        paths["pose_img"])
    coords = rng.uniform(0.1, 0.9, (18, 2))
    paths["pose_txt"].write_text("".join(f"{x} {y}\n" for x, y in coords))
    return {k: str(v) for k, v in paths.items()}


def test_pose_canvas_and_inputs_equal_jax(j_demo, inputs):
    for path in (inputs["pose_txt"], inputs["pose_img"], None):
        np.testing.assert_array_equal(demo.load_pose_canvas(path, SIZE),
                                      j_demo.load_pose_canvas(path, SIZE))
    canvas, pose, pixels = demo.demo_inputs(
        inputs["source"], inputs["pose_img"], inputs["pose_txt"], SIZE)
    s_img = j_pre.load_image(inputs["source"], (SIZE, SIZE))
    np.testing.assert_array_equal(canvas, np.concatenate(
        [j_pre.to_neg1_1(s_img), np.full((SIZE, SIZE, 3), -1.0, np.float32)],
        axis=1))
    np.testing.assert_array_equal(pose, np.concatenate(
        [j_demo.load_pose_canvas(inputs["pose_img"], SIZE),
         j_demo.load_pose_canvas(inputs["pose_txt"], SIZE)], axis=1))
    np.testing.assert_array_equal(pixels, j_pre.clip_preprocess(s_img))


def _numpy(module):
    return {k: v.detach().float().numpy() for k, v in
            module.state_dict().items()}


def test_demo_image_matches_jax(inputs):
    args = demo.parse_args(["--source", inputs["source"], "--target_pose",
                            inputs["pose_txt"], "--tiny_config",
                            "--random_init", "--device", "cpu"])
    cfg = demo.model_configs(True)
    models, dino = demo.build_models(args, cfg, torch.device("cpu"))
    canvas, pose, pixels = demo.demo_inputs(inputs["source"], None,
                                            inputs["pose_txt"], SIZE)
    latents = np.random.default_rng(1).standard_normal(
        (1, SIZE // 8, SIZE // 4, 4)).astype(np.float32)
    steps = 3
    got = demo.generate(models, dino, canvas, pose, pixels, steps=steps,
                        guidance_scale=2.0, encoder_cache_interval=1,
                        generator=torch.Generator().manual_seed(0),
                        latents=latents, compute_dtype=torch.float32,
                        deterministic_vae=True, device="cpu")

    j_tiny = j_tiny_configs()
    jparams = {"unet": convert_unet(_numpy(models["unet"])),
               "vae": convert_vae(_numpy(models["vae"])),
               "image_proj": convert_image_proj(_numpy(models["image_proj"])),
               "pose_proj": convert_pose_proj(_numpy(models["pose_proj"]))}
    feats = j_dino_features(convert_dinov2(_numpy(dino)),
                            jnp.asarray(pixels)[None], cfg=j_tiny.dino,
                            compute_dtype=jnp.float32)
    want = j_stage2(jparams, jnp.asarray(canvas)[None],
                    jnp.asarray(pose)[None], feats, None,
                    jax.random.PRNGKey(0), latents,
                    unet_cfg=j_tiny.unet2(with_class_embed=False),
                    vae_cfg=j_tiny.vae, num_steps=steps, guidance_scale=2.0,
                    scheduler="ddim", compute_dtype=jnp.float32,
                    deterministic_vae=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_missing_checkpoint_flags_exit(inputs):
    with pytest.raises(SystemExit, match="--random_init"):
        demo.main(["--source", inputs["source"], "--target_pose",
                   inputs["pose_txt"], "--device", "cpu"])
    with pytest.raises(SystemExit, match="--sd --dinov2"):
        demo.main(["--source", inputs["source"], "--target_pose",
                   inputs["pose_txt"], "--ckpt", "x.pt", "--device", "cpu"])


def test_prerendered_pose_image_accepted(inputs, tmp_path, capsys):
    out = tmp_path / "r.png"
    assert demo.main(["--source", inputs["source"], "--target_pose",
                      inputs["pose_img"], "--out", str(out), "--size",
                      str(SIZE), "--steps", "2", "--tiny_config",
                      "--device", "cpu"]) == str(out)
    arr = np.asarray(Image.open(out))
    assert arr.shape == (SIZE, SIZE, 3) and arr.std() > 0
    assert "wrote" in capsys.readouterr().out


def _write_reference_files(root, models, dino):
    """The demo's modules in the released layouts: the monolithic
    checkpoint (``unet.`` / ``pose_proj.`` / ``image_proj_model.`` keys in
    a DeepSpeed ``module`` wrapper), an SD-2.1 dir's ``vae/`` and an HF
    DINOv2 dir (with its ``mask_token``)."""
    ckpt = os.path.join(root, "pcdms_ckpt.pt")
    os.makedirs(os.path.join(root, "sd21", "vae"))
    os.makedirs(os.path.join(root, "dinov2"))

    def f32(module, prefix=""):
        return {prefix + k: v.detach().float() for k, v in
                module.state_dict().items()}
    torch.save({"module": {**f32(models["unet"], "unet."),
                           **f32(models["pose_proj"], "pose_proj."),
                           **f32(models["image_proj"], "image_proj_model.")}},
               ckpt)
    torch.save(f32(models["vae"]), os.path.join(
        root, "sd21", "vae", "diffusion_pytorch_model.bin"))
    dsd = f32(dino)
    dsd["embeddings.mask_token"] = torch.zeros(
        1, dsd["embeddings.cls_token"].shape[-1])
    torch.save(dsd, os.path.join(root, "dinov2", "pytorch_model.bin"))
    return ["--ckpt", ckpt, "--sd", os.path.join(root, "sd21"), "--dinov2",
            os.path.join(root, "dinov2")]


def test_checkpoint_run_is_byte_identical_to_random_init(inputs, tmp_path,
                                                         monkeypatch):
    """The full-width path's loading at the tiny geometry: without
    ``--tiny_config`` the demo takes ``model_configs(False)``, here the
    tiny configurations."""
    tiny = demo.model_configs(True)
    monkeypatch.setattr(demo, "model_configs", lambda _: tiny)
    base = ["--source", inputs["source"], "--target_pose",
            inputs["pose_txt"], "--size", str(SIZE), "--steps", "2",
            "--device", "cpu"]
    rand = str(tmp_path / "random.png")
    demo.main(base + ["--random_init", "--out", rand])
    args = demo.parse_args(base + ["--random_init"])
    models, dino = demo.build_models(args, tiny, torch.device("cpu"))
    assert "class_embedding.linear_1.weight" not in models[
        "unet"].state_dict()
    flags = _write_reference_files(str(tmp_path), models, dino)
    loaded = str(tmp_path / "loaded.png")
    demo.main(base + flags + ["--out", loaded])
    assert open(rand, "rb").read() == open(loaded, "rb").read()


def _code_cells():
    with open(os.path.join(ROOT, "examples", "demo_torch.ipynb")) as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def test_notebook_cells_execute(tmp_path, monkeypatch):
    """Every code cell in one namespace at the tiny geometry on the CPU
    from an empty directory: the smoke-mode fallbacks synthesise the
    inputs and the last cell writes result.png."""
    code = _code_cells()
    assert len(code) >= 5
    assert not any("nbformat" in src or "jax" in src for src in code)
    monkeypatch.setenv("PCDMS_DEMO_TINY", "1")
    monkeypatch.setenv("PCDMS_DEMO_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    ns = {}
    for src in code:
        exec(compile(src, "<demo_torch.ipynb>", "exec"), ns)
    assert ns["result"].shape == (SIZE, SIZE, 3)
    assert np.isfinite(ns["result"]).all()
    assert (tmp_path / "result.png").exists()


def test_notebook_is_regenerable():
    pytest.importorskip("nbformat")
    gen = _load(os.path.join(ROOT, "examples",
                             "make_demo_notebook_torch.py"), "gen_nb_torch")
    fresh = [c.source for c in gen.build().cells if c.cell_type == "code"]
    assert fresh == _code_cells()
    with open(os.path.join(ROOT, "examples", "demo_torch.ipynb")) as f:
        committed = json.load(f)["cells"]
    assert [c.source for c in gen.build().cells] == [
        "".join(c["source"]) for c in committed]
