"""The port's stage-3 and stage-1 training against the JAX package's, f32
on the CPU at the tiny geometry:

* the stage-3 loss and the gradients of ``unet`` and ``image_proj``
  against ``jax.value_and_grad`` of ``stage3_loss_fn``, with the JAX loss's
  own draws injected, for epsilon and v_prediction, with plain attention
  and through the flash Function (its plain versions on the CPU, 512 tokens
  at level 0); the stage-1 loss and the prior's gradients the same way;
* the trainer CLIs (``cli/stage{1,2,3}_train.main``, ``--tiny_config
  --random_init --device cpu``) on synthetic batches, on the DeepFashion
  fixture on the fly, and from ``--cache_embeddings``: each trains, writes
  ``step_<N>.pt`` and resumes bit for bit, and the first batch it feeds the
  loss equals the first batch of the JAX CLI's ``make_batches`` on the same
  flags (embeddings at the f32 bar, the encoders computing in f32 on both
  sides; in bf16 the two frameworks round at different points);
* the pretrained branches from files saved from seeded random inits, the
  ``--report_to tensorboard`` writer, and the refusals.

Bar: f32 atol 1e-4, rtol 1e-3.
"""

import dataclasses
import functools
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcdms_tpu.train.encoders as j_encoders
from pcdms_tpu.compat.torch_convert import (
    convert_image_proj, convert_prior, convert_unet, convert_vae,
)
from pcdms_tpu.cli import (
    stage1_train as j_stage1_cli, stage2_train as j_stage2_cli,
    stage3_train as j_stage3_cli,
)
from pcdms_tpu.train.stage1 import stage1_loss_fn as j_stage1_loss_fn
from pcdms_tpu.train.stage3 import stage3_loss_fn as j_stage3_loss_fn

from pcdms_tpu_torch.cli import stage1_train, stage2_train, stage3_train
from pcdms_tpu_torch.compat.from_jax import (
    image_proj_state_dict, prior_state_dict, unet_state_dict,
)
from pcdms_tpu_torch.diffusion.schedules import prior_schedule, sd21_schedule
from pcdms_tpu_torch.models.prior_transformer import (
    PriorConfig, PriorTransformer,
)
from pcdms_tpu_torch.models.projections import ImageProjModel
from pcdms_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig
from pcdms_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from pcdms_tpu_torch.ops import flash_attention_bwd as fb
from pcdms_tpu_torch.train import checkpoint as ckpt
from pcdms_tpu_torch.train import stage1 as t_stage1, stage3 as t_stage3
from pcdms_tpu_torch.train.stage1 import stage1_loss
from pcdms_tpu_torch.train.stage3 import stage3_loss

from _torch_common import (
    TINY, TOL, from_torch, n, one_thread, port_config, t, vit_pair,
)
from test_datasets import fake_df  # noqa: F401  (the shared fixture)

H, W = 128, 256             # 16 x 32 latents: 512 tokens at level 0


def _stage3_batch(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "target_image": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
        "gen_image": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
        "dino_features": rng.standard_normal((b, 5, 24)).astype(np.float32),
    }


def _stage3_jax_draws(rng, b, lh, lw):
    """The JAX stage-3 loss's draws (``pcdms_tpu/train/stage3.py:33-47``)
    as numpy, in the port's names."""
    rng_v1, rng_v2, rng_noise, rng_off, rng_t = jax.random.split(rng, 5)
    shape = (b, lh, lw, 4)
    return {
        "vae_target": jax.random.normal(rng_v1, shape, jnp.float32),
        "vae_gen": jax.random.normal(rng_v2, shape, jnp.float32),
        "noise": jax.random.normal(rng_noise, shape, jnp.float32),
        "offset": jax.random.normal(rng_off, (b, 1, 1, 4), jnp.float32),
        "timesteps": jax.random.randint(rng_t, (b,), 0, 1000),
    }


def _stage3_models(unet_cfg, seed):
    """(JAX trainable params, JAX vae, port trainable modules, port vae)
    with the same non-zero weights."""
    torch.manual_seed(seed)
    ju, tu = from_torch(UNet2DConditionModel(port_config(unet_cfg,
                                                         UNetConfig)),
                        convert_unet, seed)
    jv, tv = from_torch(AutoencoderKL(port_config(TINY.vae, VAEConfig)),
                        convert_vae, seed + 1)
    ji, ti = from_torch(ImageProjModel(**TINY.image_proj_kwargs),
                        convert_image_proj, seed + 2)
    return {"unet": ju, "image_proj": ji}, jv, {"unet": tu,
                                                "image_proj": ti}, tv


@pytest.fixture(scope="module")
def stage3_jax():
    """{prediction type: (batch, rng, loss, grads)} of the JAX loss, made
    once each (JAX takes plain attention on the CPU either way)."""
    jparams, jvae, _, _ = _stage3_models(TINY.unet3, 60)
    batch = _stage3_batch(2, H, W)
    rng = jax.random.PRNGKey(9)
    preds = ("epsilon", "v_prediction")
    fns = [jax.value_and_grad(j_stage3_loss_fn(
        TINY.unet3, jvae, vae_cfg=TINY.vae, noise_offset=0.1,
        prediction_type=pred, compute_dtype=jnp.float32), has_aux=True)
        for pred in preds]
    outs = jax.jit(lambda *a: [f(*a) for f in fns])(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    return {pred: (batch, rng, float(loss), jax.tree.map(np.asarray, grads))
            for pred, ((loss, _), grads) in zip(preds, outs)}


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("use_flash", [False, True])
def test_stage3_loss_and_grads_match_jax(use_flash, pred, monkeypatch,
                                         stage3_jax):
    batch, rng, jloss, jgrads = stage3_jax[pred]
    cfg = dataclasses.replace(TINY.unet3, use_flash=use_flash)
    _, _, models, vae = _stage3_models(cfg, 60)
    calls = []
    orig = fb.flash_fwd_lse_plain
    monkeypatch.setattr(fb, "flash_fwd_lse_plain",
                        lambda *a: calls.append(1) or orig(*a))
    draws = {k: t(np.asarray(v)) for k, v in
             _stage3_jax_draws(rng, 2, H // 8, W // 8).items()}
    loss = stage3_loss(models, vae, {k: t(v) for k, v in batch.items()},
                       draws, schedule=sd21_schedule(pred), noise_offset=0.1,
                       compute_dtype=torch.float32)
    loss.backward()
    # level 0: one down-block and two up-block transformers
    assert len(calls) == (3 if use_flash else 0)
    np.testing.assert_allclose(loss.item(), jloss, **TOL)
    converters = {"unet": unet_state_dict, "image_proj": image_proj_state_dict}
    for name, module in models.items():
        want = converters[name](jgrads[name])
        got = {k: p.grad for k, p in module.named_parameters()}
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k] is not None, k
            np.testing.assert_allclose(n(got[k]), want[k], err_msg=k, **TOL)


def test_stage3_draws_shapes_and_loss_fn():
    """``stage3_loss_fn`` draws the five inputs on the batch's device and
    gives ``stage3_loss`` of those draws."""
    gen = torch.Generator().manual_seed(3)
    d = t_stage3.stage3_draws(gen, 2, (8, 8))
    assert [tuple(v.shape) for v in d.values()] == [
        (2, 8, 8, 4)] * 3 + [(2, 1, 1, 4), (2,)]
    assert list(d) == ["vae_target", "vae_gen", "noise", "offset",
                       "timesteps"]
    _, _, models, vae = _stage3_models(TINY.unet3, 61)
    batch = {k: t(v) for k, v in _stage3_batch(2, 64, 64).items()}
    loss_fn = t_stage3.stage3_loss_fn(vae, compute_dtype=torch.float32)
    loss, _ = loss_fn(models, batch, torch.Generator().manual_seed(4))
    want = stage3_loss(models, vae, batch, t_stage3.stage3_draws(
        torch.Generator().manual_seed(4), 2, (8, 8)),
        schedule=sd21_schedule(), compute_dtype=torch.float32)
    assert torch.equal(loss, want)


def _stage1_batch(b, e, seed=1):
    rng = np.random.default_rng(seed)
    return {"s_embed": rng.standard_normal((b, e)).astype(np.float32),
            "t_embed": rng.standard_normal((b, e)).astype(np.float32),
            "s_pose": rng.random((b, 36), dtype=np.float32),
            "t_pose": rng.random((b, 36), dtype=np.float32)}


@pytest.mark.parametrize("noise_offset", [0.1, 0.0])
def test_stage1_loss_and_grads_match_jax(noise_offset):
    torch.manual_seed(70)
    jparams, prior = from_torch(
        PriorTransformer(port_config(TINY.prior, PriorConfig)), convert_prior,
        70)
    batch = _stage1_batch(3, TINY.prior.embedding_dim)
    rng = jax.random.PRNGKey(5)
    loss_fn = j_stage1_loss_fn(TINY.prior, noise_offset=noise_offset,
                               compute_dtype=jnp.float32)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    r_noise, r_off, r_t = jax.random.split(rng, 3)
    e = TINY.prior.embedding_dim
    draws = {"noise": t(np.asarray(jax.random.normal(r_noise, (3, e)))),
             "offset": t(np.asarray(jax.random.normal(r_off, (3, 1)))),
             "timesteps": t(np.asarray(jax.random.randint(r_t, (3,), 0,
                                                          1000)))}
    loss = stage1_loss({"prior": prior}, {k: t(v) for k, v in batch.items()},
                       draws, schedule=prior_schedule(),
                       noise_offset=noise_offset, compute_dtype=torch.float32)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    want = prior_state_dict(jax.tree.map(np.asarray, jgrads))
    got = {k: p.grad for k, p in prior.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(n(got[k]), want[k], err_msg=k, **TOL)
    # the loss function draws noise (B, E), offset (B, 1), timesteps (B,)
    d = t_stage1.stage1_draws(torch.Generator().manual_seed(0), 3, e)
    assert [tuple(v.shape) for v in d.values()] == [(3, e), (3, 1), (3,)]
    loss2, _ = t_stage1.stage1_loss_fn(compute_dtype=torch.float32)(
        {"prior": prior}, {k: t(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0))
    assert torch.isfinite(loss2)


# --------------------------------------------------------------------------
# the trainer CLIs
# --------------------------------------------------------------------------

CLIS = {1: stage1_train, 2: stage2_train, 3: stage3_train}
J_CLIS = {1: j_stage1_cli, 2: j_stage2_cli, 3: j_stage3_cli}
LOSS_FNS = {1: (t_stage1, "stage1_loss_fn"), 3: (t_stage3, "stage3_loss_fn")}
# the f16 caches: DINOv2 features (stages 2 and 3)
F16_KEYS = {"dino_features"}


def _flags(stage, mode, root, json_path, out, cache):
    """The flags both packages' CLIs take (the port adds ``--device``)."""
    flags = ["--tiny_config", "--random_init", "--output_dir", out,
             "--img_height", "64", "--img_width", "64",
             "--train_batch_size", "2", "--log_every", "1",
             "--lr_warmup_steps", "1", "--dataloader_num_workers", "2"]
    if mode == "synthetic":
        return flags + ["--synthetic_data"]
    flags += ["--json_path", json_path, "--image_root_path", str(root)]
    if stage == 3:
        flags += ["--gen_dir", os.path.join(root, "gen")]
    if mode == "cache":
        flags += ["--cache_embeddings", cache]
    return flags


def _capture_batches(monkeypatch, stage):
    """Record every batch the CLI's loss function is given."""
    if stage == 2:
        from pcdms_tpu_torch.train import stage2 as module
        name = "stage2_loss_fn"
    else:
        module, name = LOSS_FNS[stage]
    orig, seen = getattr(module, name), []

    def factory(*a, **k):
        fn = orig(*a, **k)

        def loss_fn(models, batch, gen):
            seen.append({k: v.detach().clone() for k, v in batch.items()})
            return fn(models, batch, gen)
        return loss_fn

    monkeypatch.setattr(module, name, factory)
    return seen


def _jax_first_batch(stage, mode, flags, frozen_dir, monkeypatch):
    """The first batch of the JAX CLI's ``make_batches`` on ``flags``, with
    the port run's frozen encoders carried over and computing in f32."""
    from pcdms_tpu.compat.torch_convert import (
        convert_clip_vision, convert_dinov2, state_dict_to_numpy,
    )
    from pcdms_tpu_torch.train.frozen import load_frozen
    for fn in ("dino_features", "clip_image_embed"):
        monkeypatch.setattr(j_encoders, fn, functools.partial(
            getattr(j_encoders, fn), compute_dtype=jnp.float32))
    cli = J_CLIS[stage]
    args = cli.parse_args(flags)
    enc = {}
    if mode != "synthetic":
        bundle = load_frozen(frozen_dir)
        if "dino" in bundle:
            enc["dino"] = convert_dinov2(state_dict_to_numpy(bundle["dino"]))
        if "clip" in bundle:
            enc["clip"] = convert_clip_vision(
                state_dict_to_numpy(bundle["clip"]))
    aux = j_stage2_cli.ModelAux(
        vae_cfg=TINY.vae, clip_cfg=TINY.clip, dino_cfg=TINY.dino,
        dino_tokens=5, dino_dim=TINY.dino.hidden_size,
        clip_dim=TINY.clip.projection_dim)
    if stage == 1:
        gen = cli.make_batches(args, enc.get("clip"), clip_cfg=TINY.clip,
                               embed_dim=TINY.prior.embedding_dim)
    elif stage == 2:
        gen = cli.make_batches(args, enc.get("clip"), enc.get("dino"),
                               clip_cfg=TINY.clip, dino_cfg=TINY.dino,
                               aux=aux)
    else:
        gen = cli.make_batches(args, enc.get("dino"), dino_cfg=TINY.dino,
                               aux=aux)
    return {k: np.asarray(v, np.float32) for k, v in next(gen).items()}


def _state_equal(a, b):
    assert a.step == b.step
    for (name, x), (_, y) in zip(a.named, b.named):
        assert torch.equal(x, y), name
        sa, sb = a.optimizer.state[x], b.optimizer.state[y]
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], sb[key]), (name, key)


@pytest.mark.parametrize("mode", ["synthetic", "data", "cache"])
@pytest.mark.parametrize("stage", [3, 1, 2])
def test_cli_trains_resumes_and_feeds_the_jax_batch(
        fake_df, tmp_path, monkeypatch, stage, mode):  # noqa: F811
    """2 steps and ``step_2.pt``; resumed at step 2 the state is the saved
    one bit for bit; resumed to step 3. The first batch the loss got equals
    the JAX CLI's first batch on the same flags."""
    root, json_path = fake_df
    cli = CLIS[stage]
    flags = _flags(stage, mode, root, json_path, str(tmp_path / "out"),
                   str(tmp_path / "port_cache"))
    argv = flags + ["--device", "cpu", "--frozen_dir",
                    str(tmp_path / "frozen")]
    monkeypatch.setattr(cli, "make_batches", functools.partial(
        cli.make_batches, encoder_dtype=torch.float32))
    seen = _capture_batches(monkeypatch, stage)

    first = cli.main(argv + ["--max_train_steps", "2"])
    assert first.step == 2 and ckpt.latest_step(tmp_path / "out") == 2
    assert (tmp_path / "out" / "step_2.pt").exists()
    restored = cli.main(argv + ["--max_train_steps", "2",
                                "--resume_from_checkpoint"])
    _state_equal(first, restored)
    last = cli.main(argv + ["--max_train_steps", "3",
                            "--resume_from_checkpoint"])
    assert last.step == 3 and ckpt.latest_step(tmp_path / "out") == 3
    assert all(torch.isfinite(p).all() for p in last.params)

    jflags = _flags(stage, mode, root, json_path, str(tmp_path / "out"),
                    str(tmp_path / "jax_cache"))
    want = _jax_first_batch(stage, mode, jflags, str(tmp_path / "frozen"),
                            monkeypatch)
    got = seen[0]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = n(got[k])
        assert g.shape == w.shape, k
        if k.endswith(("_embed", "_features")) and mode != "synthetic":
            if mode == "cache" and k in F16_KEYS:
                ulp = np.spacing(np.abs(w).astype(np.float16)).astype(
                    np.float32)
                assert np.all(np.abs(g - w) <= TOL["atol"]
                              + TOL["rtol"] * np.abs(w) + ulp), k
            else:
                np.testing.assert_allclose(g, w, err_msg=k, **TOL)
        else:
            assert np.array_equal(g, w), k


# --------------------------------------------------------------------------
# pretrained branches, tensorboard, refusals
# --------------------------------------------------------------------------

def _save_dir(directory, sd, name="diffusion_pytorch_model.bin"):
    os.makedirs(directory, exist_ok=True)
    torch.save({k: v.detach().clone() for k, v in sd.items()},
               os.path.join(directory, name))


def test_stage3_trainer_grows_conv_in_from_a_4_channel_unet(tmp_path):
    """SD-2.1's 4-channel UNet: conv_in grows to 8 inputs with zeros (the
    JAX CLI's ``_grow_conv_in`` gives the same weight), the rest of the
    file and the VAE load as they are, and the trainer takes a step."""
    from pcdms_tpu.compat.torch_convert import state_dict_to_numpy
    from pcdms_tpu_torch.compat.from_jax import unet_state_dict
    torch.manual_seed(80)
    cfg4 = dataclasses.replace(port_config(TINY.unet3, UNetConfig),
                               in_channels=4)
    sd4 = UNet2DConditionModel(cfg4).state_dict()
    vae_sd = AutoencoderKL(port_config(TINY.vae, VAEConfig)).state_dict()
    root = str(tmp_path / "sd21")
    _save_dir(os.path.join(root, "unet"), sd4)
    _save_dir(os.path.join(root, "vae"), vae_sd)
    argv = ["--tiny_config", "--synthetic_data", "--device", "cpu",
            "--pretrained_model_name_or_path", root, "--output_dir",
            str(tmp_path / "out"), "--img_height", "64", "--img_width", "64",
            "--train_batch_size", "2", "--lr_warmup_steps", "1"]
    args = stage3_train.parse_args(argv)
    stage3_train.check_supported(args)
    cfg, trainable, vae, dino, _ = stage3_train.build_models(args, "cpu")
    assert cfg.in_channels == 8 and dino is None
    w = trainable["unet"].conv_in.weight.detach()
    assert w.shape[1] == 8 and not w[:, 4:].any()
    assert torch.equal(w[:, :4], sd4["conv_in.weight"])
    grown = j_stage2_cli._grow_conv_in(
        convert_unet(state_dict_to_numpy(sd4)), TINY.unet3,
        jax.random.PRNGKey(0))
    np.testing.assert_array_equal(
        w.numpy(), unet_state_dict(grown)["conv_in.weight"])
    state = trainable["unet"].state_dict()
    for key, value in sd4.items():
        if key != "conv_in.weight":
            assert torch.equal(state[key], value), key
    for key, value in vae_sd.items():
        assert torch.equal(vae.state_dict()[key], value), key
    assert stage3_train.main(argv + ["--max_train_steps", "1"]).step == 1


def test_stage1_trainer_loads_the_prior(tmp_path):
    """``--prior_path`` loads the prior (without it the prior is drawn from
    ``--seed``); with the DeepFashion data path ``--image_encoder_path``
    loads CLIP."""
    torch.manual_seed(81)
    prior_sd = PriorTransformer(port_config(TINY.prior,
                                            PriorConfig)).state_dict()
    _save_dir(str(tmp_path / "prior"), prior_sd)
    clip_sd = vit_pair(TINY.clip, 82)[1].state_dict()
    _save_dir(str(tmp_path / "clip"), clip_sd, "pytorch_model.bin")
    base = ["--tiny_config", "--device", "cpu", "--output_dir",
            str(tmp_path / "out"), "--train_batch_size", "2"]
    args = stage1_train.parse_args(base + [
        "--prior_path", str(tmp_path / "prior"), "--json_path", "x.json",
        "--image_encoder_path", str(tmp_path / "clip")])
    stage1_train.check_supported(args)
    _, trainable, clip = stage1_train.build_models(args, "cpu")
    for key, value in prior_sd.items():
        assert torch.equal(trainable["prior"].state_dict()[key], value), key
    for key, value in clip_sd.items():
        assert torch.equal(clip.state_dict()[key], value), key
    drawn = stage1_train.build_models(stage1_train.parse_args(
        base + ["--synthetic_data"]), "cpu")
    assert drawn[2] is None
    assert not torch.equal(drawn[1]["prior"].proj_in.weight,
                           prior_sd["proj_in.weight"])
    with pytest.raises(SystemExit, match="--image_encoder_path required"):
        stage1_train.check_supported(stage1_train.parse_args(
            base + ["--json_path", "x.json"]))


class _Writer:
    def __init__(self):
        self.scalars = []
        self.flushed = False

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, step, value))

    def flush(self):
        self.flushed = True


def _stage1_synthetic(tmp_path, *extra):
    return stage1_train.main([
        "--tiny_config", "--random_init", "--synthetic_data", "--device",
        "cpu", "--output_dir", str(tmp_path), "--train_batch_size", "2",
        "--max_train_steps", "3", "--log_every", "2", *extra])


def test_report_to_tensorboard(tmp_path, monkeypatch):
    """The writer gets train_loss and examples_per_sec at the log steps
    (step 1 and every ``--log_every``), in ``<output_dir>/logs``."""
    from pcdms_tpu_torch.train import loop
    writer, dirs = _Writer(), []
    monkeypatch.setattr(loop, "make_tensorboard_writer",
                        lambda d: dirs.append(d) or writer)
    assert _stage1_synthetic(tmp_path, "--report_to",
                             "tensorboard").step == 3
    assert dirs == [str(tmp_path) + "/logs"]
    assert [(tag, step) for tag, step, _ in writer.scalars] == [
        ("train_loss", 1), ("examples_per_sec", 1), ("train_loss", 2),
        ("examples_per_sec", 2)]
    assert all(np.isfinite(v) and v > 0 for _, _, v in writer.scalars)
    assert writer.flushed


def test_report_to_tensorboard_without_tensorboard(tmp_path, monkeypatch,
                                                   caplog):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with caplog.at_level(logging.WARNING):
        assert _stage1_synthetic(tmp_path, "--report_to",
                                 "tensorboard").step == 3
    assert "tensorboard unavailable" in caplog.text


_NEW_REFUSALS = [
    ("--random_init", "--synthetic_data", "--zero1"),
    ("--random_init", "--synthetic_data", "--dcn_slices", "2"),
    ("--random_init",),
]


@pytest.mark.parametrize("extra", [list(e) for e in _NEW_REFUSALS])
@pytest.mark.parametrize("stage", [1, 3])
def test_new_clis_refuse(tmp_path, stage, extra):
    """--zero1 trains at a world of 1 and checkpoints; --dcn_slices 2 needs
    a world that divides into 2 slices (ValueError, as the JAX package
    raises with one device); the data path exits without a pair list."""
    argv = ["--output_dir", str(tmp_path), "--device", "cpu",
            "--tiny_config"] + extra
    if "--zero1" in extra:
        with one_thread():
            state = CLIS[stage].main(argv + [
                "--img_height", "64", "--img_width", "64",
                "--train_batch_size", "2", "--max_train_steps", "1"])
        assert state.step == 1 and ckpt.latest_step(tmp_path) == 1
        return
    exc, match = ((SystemExit, "--json_path required without "
                   "--synthetic_data") if "--synthetic_data" not in extra
                  else (ValueError, "1 devices do not divide into 2 slices"))
    with pytest.raises(exc, match=match):
        CLIS[stage].main(argv)


def test_stage3_cli_needs_gen_dir(tmp_path):
    with pytest.raises(SystemExit, match="--gen_dir required"):
        stage3_train.main(["--output_dir", str(tmp_path), "--device", "cpu",
                           "--random_init", "--json_path", "x.json"])


def test_profiling_and_tree_helpers(tmp_path):
    """``param_count`` / ``param_bytes`` against the JAX package's on the
    same prior; ``trace`` writes a chrome trace; ``timed`` and
    ``ThroughputMeter`` read the host clock."""
    from pcdms_tpu.utils.tree import (
        param_bytes as j_param_bytes, param_count as j_param_count,
    )
    from pcdms_tpu_torch.utils.profiling import ThroughputMeter, timed, trace
    from pcdms_tpu_torch.utils.tree import param_bytes, param_count
    torch.manual_seed(83)
    jparams, prior = from_torch(
        PriorTransformer(port_config(TINY.prior, PriorConfig)), convert_prior,
        83)
    jparams = jax.tree.map(jnp.asarray, jparams)
    assert param_count(prior) == param_count({"prior": prior}) == int(
        j_param_count(jparams))
    assert param_bytes(prior) == int(j_param_bytes(jparams))
    assert param_bytes(prior.to(torch.bfloat16)) * 2 == param_bytes(
        prior.float())
    with trace(str(tmp_path / "prof")):
        out, seconds = timed(torch.matmul, torch.ones(8, 8), torch.ones(8, 8))
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert float(out[0, 0]) == 8.0 and seconds > 0
    meter = ThroughputMeter()
    meter.update(10)
    assert meter.rate() > 0 and meter.rate_per_device() > 0
