"""LCM distillation (``train/lcm_distill.py``) against the JAX package, f32
on the CPU: the schedule helpers exactly, the student's initialisation, and
the distillation loss and its gradients with the JAX draws injected (plain
attention and the flash Function's plain twins) on a one-level UNet, whose
level 0 has the flash route's 512 tokens. Bar: f32 atol 1e-4, rtol 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdms_tpu.compat.torch_convert import (
    convert_image_proj, convert_pose_proj, convert_unet, convert_vae,
)
from pcdms_tpu.diffusion.schedules import sd21_schedule as j_sd21_schedule
from pcdms_tpu.train import lcm_distill as j_lcm

from pcdms_tpu_torch.compat.from_jax import (
    image_proj_state_dict, pose_proj_state_dict, unet_state_dict,
)
from pcdms_tpu_torch.diffusion.schedules import sd21_schedule
from pcdms_tpu_torch.models.projections import (
    ImageProjModel, PoseCondEmbedding,
)
from pcdms_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig
from pcdms_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from pcdms_tpu_torch.nn.layers import guidance_scale_embedding
from pcdms_tpu_torch.ops import flash_attention_bwd as fb
from pcdms_tpu_torch.train import lcm_distill as t_lcm

from _torch_common import TINY, TOL, from_torch, n, one_thread, \
    port_config, stage2_batch, t

H, W2 = 128, 256          # 16 x 32 latents: 512 tokens at level 0
B, N_DDIM = 2, 10
# one level keeps JAX's compile of the three-UNet loss short
TEACHER = dataclasses.replace(TINY.unet2(True), block_out_channels=(8,),
                              cross_attn_down=(True,))
STUDENT = dataclasses.replace(TEACHER, time_cond_proj_dim=8)
STATE_DICTS = {"unet": unet_state_dict, "image_proj": image_proj_state_dict,
               "pose_proj": pose_proj_state_dict}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


# ---------------------------------------------------------------------------
# the schedule helpers and the student
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_ddim", [1, 10, 50, 1000])
def test_skipped_timesteps_match_jax(n_ddim):
    got, k = t_lcm.skipped_timesteps(1000, n_ddim)
    want, jk = j_lcm.skipped_timesteps(1000, n_ddim)
    assert k == jk and got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_ddim", [0, 7, 1001])
def test_skipped_timesteps_refuse_what_jax_refuses(n_ddim):
    for fn in (t_lcm.skipped_timesteps, j_lcm.skipped_timesteps):
        with pytest.raises(ValueError, match="must divide"):
            fn(1000, n_ddim)


def test_eps_to_x0_and_ddim_solver_step_match_jax():
    rng = np.random.default_rng(0)
    x, eps = (rng.standard_normal((4, 3, 5, 4)).astype(np.float32)
              for _ in range(2))
    ts, ss = np.array([999, 499, 19, 0]), np.array([979, 479, 0, 0])
    sched, jsched = sd21_schedule(), j_sd21_schedule()
    x0 = t_lcm.eps_to_x0(sched, t(x), t(eps), torch.from_numpy(ts))
    jx0 = j_lcm.eps_to_x0(jsched, jnp.asarray(x), jnp.asarray(eps),
                          jnp.asarray(ts))
    np.testing.assert_array_equal(n(x0), n(jx0))
    got = t_lcm.ddim_solver_step(sched, x0, t(eps), torch.from_numpy(ss))
    want = j_lcm.ddim_solver_step(jsched, jx0, jnp.asarray(eps),
                                  jnp.asarray(ss))
    np.testing.assert_array_equal(n(got), n(want))


def _unet_inputs(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 8, 16, 9)).astype(np.float32),
            np.array([999, 259][:b]),
            rng.standard_normal((b, 6, 16)).astype(np.float32),
            rng.standard_normal((b, 16)).astype(np.float32),
            rng.standard_normal((b, 8, 16, 8)).astype(np.float32))


def test_student_from_teacher_keeps_the_teachers_eps():
    """The student copies the teacher and zeroes its w-projection: its eps
    equals the teacher's at every w."""
    torch.manual_seed(0)
    _, teacher = from_torch(
        UNet2DConditionModel(port_config(TEACHER, UNetConfig)),
        convert_unet, 5)
    student = t_lcm.init_student_from_teacher(
        teacher, port_config(STUDENT, UNetConfig))
    assert float(student.time_embedding.cond_proj.weight.detach().abs(
    ).sum()) == 0
    for key, v in teacher.state_dict().items():
        assert torch.equal(student.state_dict()[key], v), key
    x, ts, ctx, cl, pose = (t(a) for a in _unet_inputs(2, 1))
    with torch.no_grad():
        want = teacher(x, ts, ctx, class_labels=cl, pose_cond=pose)
        for w in (1.0, 2.5, 7.0):
            emb = guidance_scale_embedding(torch.full((2,), w), 8)
            got = student(x, ts, ctx, class_labels=cl, pose_cond=pose,
                          timestep_cond=emb)
            torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="time_cond_proj_dim"):
        t_lcm.init_student_from_teacher(teacher, teacher.cfg)


# ---------------------------------------------------------------------------
# the distillation loss and its gradients
# ---------------------------------------------------------------------------

def _pair(module, convert, seed):
    torch.manual_seed(seed)
    return from_torch(module, convert, seed)


def _models(student_cfg):
    """(JAX student params, JAX teacher, JAX vae, port student, port
    teacher, port vae): distinct non-zero weights everywhere, the student's
    w-projection included."""
    js, ts, jt, tt = {}, {}, {}, {}
    for side, j, m, base in (("s", js, ts, 10), ("t", jt, tt, 20)):
        cfg = student_cfg if side == "s" else TEACHER
        j["unet"], m["unet"] = _pair(UNet2DConditionModel(
            port_config(cfg, UNetConfig)), convert_unet, base)
        j["image_proj"], m["image_proj"] = _pair(ImageProjModel(
            **TINY.image_proj_kwargs), convert_image_proj, base + 1)
        j["pose_proj"], m["pose_proj"] = _pair(PoseCondEmbedding(
            **TINY.pose_proj_kwargs), convert_pose_proj, base + 2)
    jv, tv = _pair(AutoencoderKL(port_config(TINY.vae, VAEConfig)),
                   convert_vae, 30)
    return js, jt, jv, ts, tt, tv


def _jax_lcm_draws(rng, b, lh, lw, w_min=1.5, w_max=4.0):
    """The JAX loss's draws (``pcdms_tpu/train/lcm_distill.py:167-195``,
    ``models/vae.py:197-199``) as numpy."""
    rng_v1, rng_v2, rng_noise, rng_idx, rng_w = jax.random.split(rng, 5)
    shape = (b, lh, lw, 4)
    return {
        "vae_gt": jax.random.normal(rng_v1, shape, jnp.float32),
        "vae_masked": jax.random.normal(rng_v2, shape, jnp.float32),
        "noise": jax.random.normal(rng_noise, shape, jnp.float32),
        "index": jax.random.randint(rng_idx, (b,), 0, N_DDIM),
        "w": jax.random.uniform(rng_w, (b,), jnp.float32, w_min, w_max),
    }


@pytest.fixture(scope="module")
def lcm_case():
    """The JAX loss and gradients, computed once (plain attention on the
    CPU either way), and the port's models."""
    js, jt, jv, ts, tt, tv = _models(STUDENT)
    loss_fn = j_lcm.lcm_distill_loss_fn(
        STUDENT, TEACHER, jax.tree.map(jnp.asarray, jt),
        jax.tree.map(jnp.asarray, jv), vae_cfg=TINY.vae,
        num_ddim_timesteps=N_DDIM, compute_dtype=jnp.float32)
    batch = stage2_batch(B, H, W2, seed=4)
    rng = jax.random.PRNGKey(11)
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, js),
        {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    draws = {k: t(np.asarray(v)) for k, v in
             _jax_lcm_draws(rng, B, H // 8, W2 // 8).items()}
    return (batch, draws, float(loss), float(aux["mean_w"]),
            jax.tree.map(np.asarray, grads), ts, tt, tv)


@pytest.mark.parametrize("use_flash", [False, True])
def test_lcm_loss_and_grads_match_jax(use_flash, monkeypatch, lcm_case):
    """The loss, mean w and the gradients of the student's unet, image_proj
    and pose_proj. With use_flash the level-0 self-attentions of the
    student under autograd go through the flash Function (its plain twins
    on the CPU); the teacher and the target, without gradient, through the
    frozen route."""
    batch, draws, jloss, jmean_w, jgrads, ts, tt, tv = lcm_case
    for side in (ts, tt):
        side["unet"].cfg = dataclasses.replace(side["unet"].cfg,
                                               use_flash=use_flash)
    calls = []
    orig = fb.flash_fwd_lse_plain
    monkeypatch.setattr(fb, "flash_fwd_lse_plain",
                        lambda *a: calls.append(1) or orig(*a))
    boundary_ts, k = t_lcm.skipped_timesteps(1000, N_DDIM)
    for m in ts.values():
        m.zero_grad(set_to_none=True)
    loss, aux = t_lcm.lcm_distill_loss(
        ts, tt, tv, {key: t(v) for key, v in batch.items()}, draws,
        schedule=sd21_schedule(), boundary_ts=boundary_ts, k=k,
        compute_dtype=torch.float32)
    loss.backward()
    assert len(calls) == (4 if use_flash else 0)   # down, mid, 2 up
    np.testing.assert_allclose(loss.item(), jloss, **TOL)
    np.testing.assert_allclose(float(aux["mean_w"]), jmean_w, **TOL)
    for name, module in ts.items():
        want = STATE_DICTS[name](jgrads[name])
        got = dict(module.named_parameters())
        assert set(want) == set(got), name
        for key, g in want.items():
            np.testing.assert_allclose(n(got[key].grad), g, **TOL,
                                       err_msg=f"{name}.{key}")


def test_lcm_draws_shapes_and_ranges():
    d = t_lcm.lcm_draws(torch.Generator().manual_seed(0), 64, (2, 3), 10,
                        1.5, 4.0)
    assert d["noise"].shape == d["vae_gt"].shape == (64, 2, 3, 4)
    assert d["index"].min() >= 0 and d["index"].max() < 10
    assert 1.5 <= float(d["w"].min()) and float(d["w"].max()) <= 4.0
