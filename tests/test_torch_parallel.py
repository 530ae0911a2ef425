"""The port's data parallelism (``parallel/mesh.py``, ``train/common.py``
with a mesh and ZeRO-1, ``train/loop.py``, ``train/checkpoint.py``, the
batch test's sharding) on ``gloo`` worlds of CPU processes.

One spawn per world size (``parallel/dryrun.py::spawn``): a world of 2 runs
every two-rank task in turn, a world of 4 the hybrid-slice step; each rank
saves its results under ``tmp_path`` and the tests below read them. The
world-1 runs happen in this process. The data-parallel stage-2 step is held
against the JAX package's ``make_train_step(zero1=True)`` on the 8 virtual
devices of ``conftest.py``, with the JAX draws injected, on the stage-2
stack of ``tests/_multihost_common.py`` with its UNet cut to one level: the
JAX compile of the four-level step alone takes about a minute on a cold
cache. Bar: f32 atol 1e-4, rtol 1e-3.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pcdms_tpu.compat.torch_convert import (
    convert_image_proj, convert_pose_proj, convert_unet, convert_vae,
)
from pcdms_tpu.parallel.mesh import make_mesh as j_make_mesh
from pcdms_tpu.parallel.mesh import shard_batch as j_shard_batch
from pcdms_tpu.train.common import TrainConfig as JTrainConfig
from pcdms_tpu.train.common import init_train_state as j_init_train_state
from pcdms_tpu.train.common import make_train_step as j_make_train_step
from pcdms_tpu.train.common import shard_train_state as j_shard_train_state
from pcdms_tpu.train.stage2 import stage2_loss_fn as j_stage2_loss_fn

from pcdms_tpu_torch.compat.from_jax import (
    image_proj_state_dict, pose_proj_state_dict, unet_state_dict,
)
from pcdms_tpu_torch.parallel import mesh as pmesh
from pcdms_tpu_torch.parallel.dryrun import (
    load_result, run_task, spawn, tiny_batch, tiny_stage2, wait,
)
from pcdms_tpu_torch.train import checkpoint as ckpt

from _torch_common import TINY, TOL, from_torch, one_thread
from test_torch_train_grads import _jax_draws

ROWS_JAX = 8            # the global batch of tests/_multihost_common.py
ROWS = 2                # the other runs' global batch: a row a rank
CFG = {"learning_rate": 1e-3, "lr_warmup_steps": 1, "max_train_steps": 100}
EMA = dict(CFG, use_ema=True)
ZERO = dict(EMA, zero1=True)
UNET = {"block_out_channels": (8,), "cross_attn_down": (True,)}
NAMES = ["p0", "p1", "p2"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _dataset(root):
    """A DeepFashion-layout root with 3 images, their pose renders and a
    test pair list of 2 pairs."""
    rng = np.random.default_rng(3)
    for d in ("train_all_png", "openpose_all_img"):
        os.makedirs(os.path.join(root, d))
    for stem in NAMES:
        for path in (f"train_all_png/{stem}.png",
                     f"openpose_all_img/{stem}_pose.jpg"):
            Image.fromarray(rng.integers(0, 256, (64, 64, 3), np.uint8)).save(
                os.path.join(root, path))
    pairs = [{"source_image": f"train_all_png/{NAMES[i]}.jpg",
              "target_image": f"train_all_png/{NAMES[i + 1]}.jpg"}
             for i in range(2)]
    with open(os.path.join(root, "test_pairs.json"), "w") as f:
        json.dump(pairs, f)


def _batchtest_argv(root, out):
    return ["--tiny_config", "--random_init", "--simple_variant",
            "--device", "cpu", "--json_path",
            os.path.join(root, "test_pairs.json"), "--image_root_path", root,
            "--save_path", out, "--img_width", "64", "--img_height", "64",
            "--num_inference_steps", "2", "--num_images_per_prompt", "2",
            "--scheduler", "ddim", "--batch_size", "1"]


def _jax_inputs(tmp, init, steps=2):
    """Saves the tiny stage-2 stack's non-zero weights to ``init`` and the
    JAX loss's draws of each step to ``draws.npz``; returns (JAX params,
    JAX vae, step rngs)."""
    models, vae = tiny_stage2(seed=0, unet=UNET)
    jp = {}
    for (name, conv), seed in zip((("unet", convert_unet),
                                   ("image_proj", convert_image_proj),
                                   ("pose_proj", convert_pose_proj)),
                                  (1, 2, 3)):
        jp[name], _ = from_torch(models[name], conv, seed)
    jvae, _ = from_torch(vae, convert_vae, 4)
    torch.save({"models": {k: m.state_dict() for k, m in models.items()},
                "vae": vae.state_dict()}, init)
    rngs = [jax.random.PRNGKey(100 + step) for step in range(steps)]
    np.savez(os.path.join(tmp, "draws.npz"), **{
        f"{k}_{step}": np.asarray(v) for step, rng in enumerate(rngs)
        for k, v in _jax_draws(rng, ROWS_JAX, 8, 16).items()})
    return jp, jvae, rngs


def _jax_reference(jp, jvae, rngs):
    """The JAX package's ZeRO-1 stage-2 step on the 8-device mesh over 2
    updates: the loss, the gradient norm and the parameters (torch names)
    after each update."""
    cfg = JTrainConfig(zero1=True, **CFG)
    mesh = j_make_mesh()
    loss_fn = j_stage2_loss_fn(dataclasses.replace(TINY.unet2(True), **UNET),
                               jvae, vae_cfg=TINY.vae,
                               compute_dtype=jnp.float32, noise_offset=0.0)
    # placed as the step leaves it, so both updates share one compile
    state = j_shard_train_state(
        j_init_train_state(jax.tree.map(jnp.asarray, jp), cfg), cfg, mesh)
    step_fn = j_make_train_step(loss_fn, cfg, mesh=mesh)
    out = []
    for step, rng in enumerate(rngs):
        batch = j_shard_batch(tiny_batch(ROWS_JAX, step), mesh)
        state, m = step_fn(state, batch, rng)
        p = jax.tree.map(np.asarray, state["params"])
        sd = {}
        for name, conv in (("unet", unet_state_dict),
                           ("image_proj", image_proj_state_dict),
                           ("pose_proj", pose_proj_state_dict)):
            sd.update({f"{name}.{k}": v for k, v in conv(p[name]).items()})
        out.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]), "params": sd})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: [result of rank 0, rank 1, ...]} of every run, and the JAX
    reference under "jax"."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    init, draws = os.path.join(tmp, "init.pt"), os.path.join(tmp, "draws.npz")
    jax_inputs = _jax_inputs(tmp, init)
    root = os.path.join(tmp, "deepfashion")
    _dataset(root)

    def spec(name, **kw):
        return dict({"kind": "train", "init": init, "unet": UNET,
                     "rows": ROWS, "steps": 2, "cfg": CFG,
                     "out": os.path.join(tmp, name)}, **kw)

    dirs = {k: os.path.join(tmp, k) for k in ("w2_ckpt", "w1_ckpt",
                                              "w1_resume", "sigterm")}
    tasks2 = [
        spec("jax_zero", rows=ROWS_JAX, draws=draws, cfg=ZERO, history=True),
        spec("w2_uninterrupted", steps=3, cfg=ZERO, history=True),
        spec("plain", steps=3, cfg=EMA),
        spec("k2", steps=4, cfg=dict(CFG, gradient_accumulation_steps=2)),
        spec("w2_ckpt", cfg=ZERO, ckpt_dir=dirs["w2_ckpt"],
             checkpointing_steps=2),
        spec("w2_resume_w2", steps=3, cfg=ZERO, ckpt_dir=dirs["w2_ckpt"],
             resume=True),
        spec("w2_resume_w1", steps=3, cfg=ZERO, ckpt_dir=dirs["w1_ckpt"],
             resume=True),
        spec("sigterm", steps=4, cfg=ZERO, ckpt_dir=dirs["sigterm"],
             sigterm=(1, 1)),
        {"kind": "batchtest", "out": os.path.join(tmp, "bt2"),
         "argv": _batchtest_argv(root, os.path.join(tmp, "png2"))},
    ]
    # the world-1 checkpoint the world-2 run resumes from, made first; the
    # worlds run while JAX compiles its step
    run_task(spec("w1_ckpt", cfg=EMA, ckpt_dir=dirs["w1_ckpt"],
                  checkpointing_steps=2))
    world2 = spawn(2, tasks2, os.path.join(tmp, "world2"), join=False)
    hybrid = spec("hybrid", rows=4, steps=1,
                  cfg=dict(CFG, zero1=True, lr_warmup_steps=0))
    world4 = spawn(4, [hybrid], os.path.join(tmp, "world4"), num_slices=2,
                   join=False)
    ref = _jax_reference(*jax_inputs)
    wait(world2)
    wait(world4)

    out = {name: [load_result(os.path.join(tmp, name), r) for r in range(2)]
           for name in [t["out"].rsplit(os.sep, 1)[1] for t in tasks2]}
    out["hybrid"] = [load_result(hybrid["out"], r) for r in range(4)]
    # the world-1 runs
    for t in (spec("jax_w1", rows=ROWS_JAX, draws=draws, history=True),
              spec("w1_uninterrupted", steps=3, cfg=EMA, history=True),
              spec("k2_w1", steps=4,
                   cfg=dict(CFG, gradient_accumulation_steps=2)),
              dict(hybrid, out=os.path.join(tmp, "hybrid_w1"),
                   cfg=dict(hybrid["cfg"], zero1=False))):
        out[t["out"].rsplit(os.sep, 1)[1]] = [run_task(t)]
    os.makedirs(dirs["w1_resume"])
    shutil.copy(ckpt.checkpoint_path(dirs["w2_ckpt"], 2), dirs["w1_resume"])
    out["w1_resume_w2"] = [run_task(spec("w1_resume_w2", steps=3, cfg=EMA,
                                         ckpt_dir=dirs["w1_resume"],
                                         resume=True))]
    out["bt1"] = [run_task({"kind": "batchtest",
                            "out": os.path.join(tmp, "bt1"),
                            "argv": _batchtest_argv(
                                root, os.path.join(tmp, "png1"))})]
    out["jax"], out["dirs"], out["tmp"] = ref, dirs, tmp
    return out


def _close(got, want):
    for name, w in want.items():
        torch.testing.assert_close(torch.as_tensor(got[name]),
                                   torch.as_tensor(np.array(w)), **TOL,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("run", ["jax_zero", "jax_w1"])
def test_data_parallel_step_matches_jax(runs, run):
    """World 2 x 4 rows with ZeRO-1 and world 1 x 8 rows without it, on the
    JAX draws: the loss, the gradient norm and every parameter after each of
    2 updates against JAX's 8-device zero1 step."""
    for result in runs[run]:
        for got_m, got_p, want in zip(result["metrics"], result["history"],
                                      runs["jax"]):
            np.testing.assert_allclose(got_m["loss"], want["loss"], **TOL)
            np.testing.assert_allclose(got_m["grad_norm"], want["grad_norm"],
                                       **TOL)
            assert set(got_p) == set(want["params"])
            _close(got_p, want["params"])


@pytest.mark.parametrize("run,world1", [("w2_uninterrupted",
                                          "w1_uninterrupted"),
                                         ("k2", "k2_w1")])
def test_world_size_invariance(runs, run, world1):
    """The port's own draws: world 2 (a row a rank) after 2 updates equals
    world 1 on the global batch, with the EMA (3 updates) and with
    gradient accumulation over 2 micro-steps."""
    want = runs[world1][0]
    for result in runs[run]:
        assert result["step"] == want["step"]
        _close(result["params"], want["params"])
        for g, w in zip(result["metrics"], want["metrics"]):
            np.testing.assert_allclose(g["loss"], w["loss"], **TOL)
        if result["history"]:
            _close(result["history"][1], want["history"][1])
            _close(result["ema"], want["ema"])
            assert not torch.equal(result["ema"]["unet.conv_in.weight"],
                                   result["params"]["unet.conv_in.weight"])


def test_zero1_shards_the_state_and_keeps_the_update(runs):
    """Each rank holds at most half of the world-1 optimizer state plus the
    largest parameter's moments, and the parameters and the EMA are
    bit-identical to the world-2 run without ZeRO-1."""
    full = runs["w1_uninterrupted"][0]["opt_bytes"]
    largest = 2 * max(p.numel() * p.element_size()
                      for p in runs["w1_uninterrupted"][0]["params"].values())
    plain = runs["plain"]
    for r, result in enumerate(runs["w2_uninterrupted"]):
        assert result["zero_group"] == [0, 1]
        assert 0 < result["opt_bytes"] <= full / 2 + largest, (r, result[
            "opt_bytes"], full)
        assert plain[r]["opt_bytes"] == full
        for name, p in plain[r]["params"].items():
            assert torch.equal(result["params"][name], p), name
            assert torch.equal(result["ema"][name], plain[r]["ema"][name])
    assert sum(r["opt_bytes"] for r in runs["w2_uninterrupted"]) == full


def test_hybrid_slices(runs):
    """Two slices over 4 ranks: ZeRO-1 groups {0, 1} and {2, 3}, one step
    equal to the world-1 step."""
    want = runs["hybrid_w1"][0]["params"]
    for r, result in enumerate(runs["hybrid"]):
        group = [0, 1] if r < 2 else [2, 3]
        assert result["zero_group"] == result["slice_ranks"] == group
        _close(result["params"], want)


def test_dcn_slices_need_a_divisible_world():
    with pytest.raises(ValueError, match="do not divide into 2 slices"):
        pmesh.make_hybrid_mesh(2, "cpu")
    mesh = pmesh.make_hybrid_mesh(1, "cpu")
    assert (mesh.world, mesh.group, mesh.slice_ranks) == (1, None, [0])


def test_checkpoints_resume_across_world_sizes(runs):
    """A world-2 ZeRO-1 checkpoint at step 2 resumes at world 2 (step 3 the
    same bits as the uninterrupted run) and at world 1 without ZeRO-1; a
    world-1 checkpoint resumes at world 2 with ZeRO-1."""
    assert ckpt.checkpoint_path(runs["dirs"]["w1_ckpt"], 2).exists()
    uninterrupted = runs["w2_uninterrupted"]
    for r, result in enumerate(runs["w2_resume_w2"]):
        assert result["step"] == 3 and len(result["metrics"]) == 1
        for name, p in uninterrupted[r]["params"].items():
            assert torch.equal(result["params"][name], p), name
            assert torch.equal(result["ema"][name],
                               uninterrupted[r]["ema"][name]), name
        _close(runs["w2_resume_w1"][r]["params"], uninterrupted[r]["params"])
    got = runs["w1_resume_w2"][0]
    assert got["step"] == 3
    _close(got["params"], runs["w1_uninterrupted"][0]["params"])
    _close(got["params"], uninterrupted[0]["params"])
    payload, _ = ckpt.load_payload(runs["dirs"]["w2_ckpt"], 2)
    assert len(payload["optimizer"]["state"]) == len(got["params"])


def test_sigterm_on_one_rank_stops_both(runs):
    """SIGTERM to rank 1 after step 1: both ranks stop at step 1 and one
    checkpoint is written."""
    assert [r["step"] for r in runs["sigterm"]] == [1, 1]
    files = sorted(os.listdir(runs["dirs"]["sigterm"]))
    assert files == ["step_1.pt"]


def test_batchtest_shards_by_rank(runs):
    """F4: the stage-2 batch test at world 2 writes, between its ranks,
    exactly the files of the world-1 run, byte for byte."""
    tmp = runs["tmp"]
    ranks = [sorted(os.path.basename(p) for p in r["written"])
             for r in runs["bt2"]]
    assert len(ranks[0]) == len(ranks[1]) == 1
    assert not set(ranks[0]) & set(ranks[1])
    one = sorted(os.listdir(os.path.join(tmp, "png1")))
    assert sorted(ranks[0] + ranks[1]) == one == sorted(
        os.listdir(os.path.join(tmp, "png2")))
    for name in one:
        with open(os.path.join(tmp, "png1", name), "rb") as a, \
                open(os.path.join(tmp, "png2", name), "rb") as b:
            assert a.read() == b.read(), name


def test_pad_and_shard_and_rows():
    """Rank r holds rows r * B .. (r + 1) * B; a ragged batch is padded by
    repeating its last row (the JAX package's pad_and_shard)."""
    x = np.arange(10)[:, None]
    for rank in range(4):
        mesh = pmesh.Mesh(rank=rank, world=4)
        got, n_pad = pmesh.pad_and_shard(mesh, x)
        want = np.concatenate([x, x[-1:], x[-1:]])[3 * rank:3 * rank + 3]
        assert n_pad == 12 and np.array_equal(got, want)
        assert pmesh.pad_and_shard(mesh, None, x)[0] is None
    mesh = pmesh.Mesh(rank=1, world=2)
    assert np.array_equal(pmesh.shard_batch({"a": x}, mesh)["a"], x[5:])
    drawn = pmesh.draw_rows(lambda n: torch.arange(n), 3, mesh)
    assert drawn.tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match="does not split"):
        pmesh.shard_batch(np.zeros(3), mesh)
