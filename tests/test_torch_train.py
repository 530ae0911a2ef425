"""The port's stage-2 training against the JAX package's, f32 on the CPU.

* DDPM helpers;
* AdamW + clipping + gradient accumulation + EMA against optax, for each
  learning-rate schedule;
* bf16 compute on f32 master weights, ``remat``, resume (bit for bit),
  SIGTERM, the frozen bundle and the CLI.

The stage-2 loss and its gradients against JAX are in
tests/test_torch_train_grads.py.

Bar: f32 atol 1e-4, rtol 1e-3 unless stated.
"""

import copy
import dataclasses
import itertools
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdms_tpu.diffusion import ddpm as jddpm
from pcdms_tpu.diffusion.schedules import sd21_schedule as j_sd21
from pcdms_tpu.train.common import (
    TrainConfig as JTrainConfig, init_train_state as j_init_state,
    make_train_step as j_make_train_step,
)

from pcdms_tpu_torch.cli.common import tiny_configs
from pcdms_tpu_torch.diffusion import ddpm
from pcdms_tpu_torch.diffusion.schedules import sd21_schedule
from pcdms_tpu_torch.models.projections import (
    ImageProjModel, PoseCondEmbedding,
)
from pcdms_tpu_torch.models.unet2d import UNet2DConditionModel
from pcdms_tpu_torch.models.vae import AutoencoderKL
from pcdms_tpu_torch.nn.layers import Conv2d, Linear
from pcdms_tpu_torch.train import checkpoint as ckpt
from pcdms_tpu_torch.train.common import (
    TrainConfig, ema_params, init_train_state, make_lr_schedule,
    make_train_step,
)
from pcdms_tpu_torch.train.frozen import (
    frozen_dir_or_build, load_trained_params,
)
from pcdms_tpu_torch.train.loop import run_training
from pcdms_tpu_torch.train.stage2 import stage2_loss_fn

from _torch_common import TOL, n, one_thread, stage2_batch, t

PORT_TINY = tiny_configs()


def stage2_models(unet_cfg, seed):
    """Port-only tiny stage-2 models, torch's own random init (no JAX):
    (trainable modules, vae)."""
    torch.manual_seed(seed)
    return ({
        "unet": UNet2DConditionModel(unet_cfg),
        "image_proj": ImageProjModel(**PORT_TINY.image_proj_kwargs),
        "pose_proj": PoseCondEmbedding(**PORT_TINY.pose_proj_kwargs),
    }, AutoencoderKL(PORT_TINY.vae).eval())


# ---------------------------------------------------------------------------
# DDPM helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["ddpm_add_noise", "ddpm_velocity"])
def test_ddpm_helpers_match_jax(fn):
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((3, 4, 5, 4)).astype(np.float32)
    noise = rng.standard_normal((3, 4, 5, 4)).astype(np.float32)
    ts = np.array([0, 517, 999])
    want = getattr(jddpm, fn)(j_sd21(), jnp.asarray(x0), jnp.asarray(noise),
                              jnp.asarray(ts))
    got = getattr(ddpm, fn)(sd21_schedule(), t(x0), t(noise), t(ts))
    np.testing.assert_allclose(n(got), n(want), **TOL)


@pytest.mark.parametrize("shape,shift", [((2, 4, 6, 4), (2, 1, 1, 4)),
                                         ((3, 16), (3, 1))])
def test_offset_noise_shape(shape, shift):
    """One standard-normal shift per (batch, channel) of NHWC noise and per
    item of (B, D) noise, as in JAX; offset 0 draws nothing."""
    noise = torch.zeros(shape)
    assert ddpm.offset_shape(noise) == shift
    j_off = jddpm.offset_noise(jax.random.PRNGKey(0), jnp.zeros(shape), 1.0)
    got = ddpm.offset_noise(torch.Generator().manual_seed(0), noise, 1.0)
    assert got.shape == j_off.shape == shape
    for x in (got, t(np.asarray(j_off))):
        first = x[:, :1, :1] if len(shape) == 4 else x[:, :1]
        assert torch.equal(x, first.expand_as(x)) and x.abs().sum() > 0
    gen = torch.Generator().manual_seed(0)
    assert ddpm.offset_noise(gen, noise, 0.0) is noise
    assert torch.equal(gen.get_state(),
                       torch.Generator().manual_seed(0).get_state())


def test_sample_timesteps_range():
    ts = ddpm.sample_timesteps(torch.Generator().manual_seed(1), 4096, 1000)
    assert ts.shape == (4096,) and ts.min() >= 0 and ts.max() <= 999
    assert len(torch.unique(ts)) > 900


# ---------------------------------------------------------------------------
# the loss in bf16, the casting layers, remat
# ---------------------------------------------------------------------------

def test_stage2_loss_fn_trains_in_bf16_with_f32_weights():
    """Under bf16 compute the f32 master weights stay f32, every trainable
    parameter gets a finite f32 gradient, and the frozen VAE gets none."""
    models, vae = stage2_models(PORT_TINY.unet2(True), 60)
    loss_fn = stage2_loss_fn(vae, compute_dtype=torch.bfloat16)
    batch = {k: t(v) for k, v in stage2_batch(2, 64, 128).items()}
    loss, _ = loss_fn(models, batch, torch.Generator().manual_seed(0))
    loss.backward()
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    for m in models.values():
        for name, p in m.named_parameters():
            assert p.dtype == torch.float32
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert all(p.grad is None for p in vae.parameters())


def test_casting_layers_keep_f32_master_weights():
    lin, conv = Linear(4, 3), Conv2d(3, 2, 3, padding=1)
    x = torch.randn(2, 5, 5, 4, dtype=torch.bfloat16)
    y = conv(lin(x).permute(0, 3, 1, 2))
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    for p in (lin.weight, lin.bias, conv.weight, conv.bias):
        assert p.dtype == p.grad.dtype == torch.float32


def test_remat_gives_the_same_gradients():
    cfg = dataclasses.replace(PORT_TINY.unet2(True), use_flash=True)
    models, vae = stage2_models(cfg, 70)
    batch = {k: t(v) for k, v in stage2_batch(1, 128, 256).items()}
    loss_fn = stage2_loss_fn(vae, compute_dtype=torch.float32)

    def grads(unet):
        m = dict(models, unet=unet)
        for mod in m.values():
            mod.zero_grad(set_to_none=True)
        loss, _ = loss_fn(m, batch, torch.Generator().manual_seed(3))
        loss.backward()
        return loss.item(), {k: p.grad.clone()
                             for k, p in unet.named_parameters()}

    remat = copy.deepcopy(models["unet"])
    remat.cfg = dataclasses.replace(remat.cfg, remat=True)
    l0, g0 = grads(models["unet"])
    l1, g1 = grads(remat)
    assert l0 == l1
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], atol=1e-7, rtol=1e-6)


# ---------------------------------------------------------------------------
# optimizer, schedules, accumulation, EMA against optax
# ---------------------------------------------------------------------------

def _toy_batches(steps):
    rng = np.random.default_rng(1)
    return [{"x": rng.standard_normal((6, 4)).astype(np.float32),
             "y": rng.standard_normal((6, 3)).astype(np.float32)}
            for _ in range(steps)]


def _j_toy_loss(params, batch, rng):
    p = params["lin"]
    loss = jnp.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)
    return loss, {}


def _t_toy_loss(models, batch, generator):
    lin = models["lin"]
    loss = torch.mean((batch["x"] @ lin.w + lin.b - batch["y"]) ** 2)
    return loss, {}


class _Toy(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(t(w.copy()))
        self.b = torch.nn.Parameter(t(b.copy()))


@pytest.mark.parametrize("updates", [1, 3])
@pytest.mark.parametrize("schedule", ["constant", "constant_with_warmup",
                                      "cosine"])
def test_optimizer_matches_optax(schedule, updates):
    """AdamW after clipping (active: max_grad_norm 0.05), accumulation over
    2 micro-batches and EMA, against the JAX train step (optax)."""
    kw = dict(learning_rate=0.05, lr_warmup_steps=2, max_train_steps=6,
              lr_scheduler=schedule, gradient_accumulation_steps=2,
              max_grad_norm=0.05, adam_weight_decay=0.1, use_ema=True,
              ema_decay=0.9)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    batches = _toy_batches(2 * updates)

    jcfg = JTrainConfig(**kw)
    jstate = j_init_state({"lin": {"w": jnp.asarray(w), "b": jnp.asarray(b)}},
                          jcfg)
    jstep = j_make_train_step(_j_toy_loss, jcfg)
    cfg = TrainConfig(**kw)
    state = init_train_state({"lin": _Toy(w, b)}, cfg)
    step = make_train_step(_t_toy_loss, cfg)
    for batch in batches:
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
        m = step(state, {k: t(v) for k, v in batch.items()}, None)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), **TOL)
    lin = state.models["lin"]
    np.testing.assert_allclose(n(lin.w), n(jstate["params"]["lin"]["w"]),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(n(lin.b), n(jstate["params"]["lin"]["b"]),
                               atol=1e-6, rtol=1e-5)
    ema = ema_params(state)["lin"]
    np.testing.assert_allclose(n(ema["w"]),
                               n(jstate["ema_params"]["lin"]["w"]),
                               atol=1e-6, rtol=1e-5)
    assert state.step == 2 * updates
    # with warmup the first update has lr = schedule(0) = 0
    moved = not np.array_equal(n(lin.w), w)
    assert moved == (updates > 1 or schedule == "constant")


@pytest.mark.parametrize("schedule", ["constant", "constant_with_warmup",
                                      "cosine"])
def test_lr_schedule_matches_optax(schedule):
    from pcdms_tpu.train.common import make_lr_schedule as j_schedule
    kw = dict(learning_rate=1e-3, lr_warmup_steps=3, max_train_steps=10,
              lr_scheduler=schedule)
    want, got = j_schedule(JTrainConfig(**kw)), make_lr_schedule(
        TrainConfig(**kw))
    for count in range(12):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12)
    assert got(0) == (1e-3 if schedule == "constant" else 0.0)


# ---------------------------------------------------------------------------
# loop: resume, SIGTERM, frozen bundle, CLI
# ---------------------------------------------------------------------------

def _tiny_training(seed=80):
    models, vae = stage2_models(PORT_TINY.unet2(True), seed)
    batch = stage2_batch(1, 64, 128)
    return models, stage2_loss_fn(vae, compute_dtype=torch.float32), batch


def test_resume_is_bit_exact(tmp_path):
    """3 steps straight == 2 steps, save, resume, 1 step (params, EMA and
    optimizer moments, bit for bit)."""
    models, loss_fn, batch = _tiny_training()
    cfg = TrainConfig(learning_rate=1e-3, lr_warmup_steps=1, use_ema=True)
    kw = dict(log_every=100, checkpointing_steps=1000)

    straight = run_training(loss_fn, copy.deepcopy(models),
                            itertools.repeat(batch), cfg, max_train_steps=3,
                            output_dir=str(tmp_path / "a"), **kw)
    run_training(loss_fn, copy.deepcopy(models), itertools.repeat(batch),
                 cfg, max_train_steps=2, output_dir=str(tmp_path / "b"),
                 **kw)
    assert ckpt.latest_step(tmp_path / "b") == 2
    resumed = run_training(loss_fn, copy.deepcopy(models),
                           itertools.repeat(batch), cfg, max_train_steps=3,
                           output_dir=str(tmp_path / "b"),
                           resume_from_checkpoint=True, **kw)
    assert straight.step == resumed.step == 3
    for (name, a), (_, b) in zip(straight.named, resumed.named):
        assert torch.equal(a, b), name
        assert torch.equal(straight.ema[name], resumed.ema[name]), name
        sa, sb = (s.optimizer.state[p] for s, p in ((straight, a),
                                                    (resumed, b)))
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"]), name
    assert ckpt.latest_step(tmp_path / "b") == 3


def test_sigterm_checkpoints_and_stops(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    models, loss_fn, batch = _tiny_training()

    def batches():
        for i in range(100):
            if i == 3:   # delivered synchronously in the main thread
                signal.raise_signal(signal.SIGTERM)
            yield batch

    state = run_training(loss_fn, models, batches(), TrainConfig(),
                         output_dir=str(tmp_path), max_train_steps=100,
                         log_every=100)
    assert 0 < state.step < 100           # stopped, not exhausted
    assert ckpt.latest_step(tmp_path) == state.step
    assert signal.getsignal(signal.SIGTERM) is before


def test_checkpoint_keeps_the_newest_five(tmp_path):
    models, loss_fn, batch = _tiny_training()
    state = run_training(loss_fn, models, itertools.repeat(batch),
                         TrainConfig(), max_train_steps=7,
                         output_dir=str(tmp_path), checkpointing_steps=1,
                         log_every=100)
    assert state.step == 7
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"step_{i}.pt" for i in range(3, 8)]


def test_frozen_bundle_and_trained_params(tmp_path):
    from pcdms_tpu_torch.models.vae import AutoencoderKL
    torch.manual_seed(0)
    a = frozen_dir_or_build(str(tmp_path), {
        "vae": lambda: AutoencoderKL(PORT_TINY.vae)})["vae"]
    torch.manual_seed(1)     # another draw: the bundle's weights win
    b = frozen_dir_or_build(str(tmp_path), {
        "vae": lambda: AutoencoderKL(PORT_TINY.vae)})["vae"]
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k

    models, loss_fn, batch = _tiny_training()
    state = run_training(loss_fn, models, itertools.repeat(batch),
                         TrainConfig(use_ema=True), max_train_steps=2,
                         output_dir=str(tmp_path / "run"), log_every=100)
    params = load_trained_params(str(tmp_path / "run"))
    assert sorted(params) == ["image_proj", "pose_proj", "unet"]
    for name, value in ema_params(state)["unet"].items():
        assert torch.equal(params["unet"][name], value)
    raw = load_trained_params(str(tmp_path / "run"), prefer_ema=False)
    models["unet"].load_state_dict(raw["unet"])


def test_cli_trains_and_resumes_on_cpu(tmp_path):
    from pcdms_tpu_torch.cli.stage2_train import main
    argv = ["--tiny_config", "--synthetic_data", "--random_init",
            "--device", "cpu", "--output_dir", str(tmp_path),
            "--img_height", "64", "--img_width", "64",
            "--train_batch_size", "2", "--log_every", "1",
            "--lr_warmup_steps", "1"]
    state = main(argv + ["--max_train_steps", "2"])
    assert state.step == 2 and ckpt.latest_step(tmp_path) == 2
    state = main(argv + ["--max_train_steps", "3",
                         "--resume_from_checkpoint"])
    assert state.step == 3 and ckpt.latest_step(tmp_path) == 3


# what each case must do: the DeepFashion data path without its pair list
# and pretrained loading without its SD-2.1 dir exit; --zero1 trains at a
# world of 1 and checkpoints (None), --dcn_slices 2 needs a world that
# divides into 2 slices, and a --report_to other than tensorboard trains,
# logging to stdout, as the JAX CLI does
_DATA_PATH = (SystemExit, "--json_path required without --synthetic_data")
_TRAINS = None
_TINY_RUN = ["--tiny_config", "--img_height", "64", "--img_width", "64",
             "--train_batch_size", "2", "--max_train_steps", "1"]
_REFUSALS = {
    (): _DATA_PATH,
    ("--random_init",): _DATA_PATH,
    ("--synthetic_data",): (SystemExit, "--pretrained_model_name_or_path "
                                        "required without --random_init"),
    ("--random_init", "--synthetic_data", "--zero1"): _TRAINS,
    ("--random_init", "--synthetic_data", "--dcn_slices", "2"): (
        ValueError, "1 devices do not divide into 2 slices"),
    ("--random_init", "--synthetic_data", "--report_to", "wandb"): _TRAINS,
}


@pytest.mark.parametrize("extra", [list(k) for k in _REFUSALS])
def test_cli_refuses_unported_flags(tmp_path, extra):
    from pcdms_tpu_torch.cli.stage2_train import main
    argv = ["--output_dir", str(tmp_path), "--device", "cpu"] + extra
    if _REFUSALS[tuple(extra)] is _TRAINS:
        with one_thread():
            state = main(argv + _TINY_RUN)
        assert state.step == 1 and ckpt.latest_step(tmp_path) == 1
        assert not (tmp_path / "logs").exists()
        return
    exc, match = _REFUSALS[tuple(extra)]
    with pytest.raises(exc, match=match) as refused:
        main(argv)
    assert "items 11" not in str(refused.value)
