"""The stage-1 prior's modules against the JAX package's on the CPU: the
noise schedules and the UnCLIP step tables exactly (float64 math stored as
float32 on both sides), the prior transformer at the tiny config in f32 at
the module bar (atol 1e-4, rtol 1e-3) with and without ``cfg_zero_cond``,
and the prior's weights carried both ways (``prior_state_dict`` and the
JAX package's ``convert_prior``)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pcdms_tpu.compat.torch_convert import convert_prior
from pcdms_tpu.diffusion import schedules as j_schedules
from pcdms_tpu.diffusion import unclip as j_unclip
from pcdms_tpu.models.prior_transformer import (
    PriorConfig as JPriorConfig, prior_apply, prior_init,
    prior_normalize_embeds as j_normalize,
    prior_post_process_latents as j_post_process,
)

from pcdms_tpu_torch.compat.from_jax import prior_state_dict
from pcdms_tpu_torch.diffusion import schedules, unclip
from pcdms_tpu_torch.models.prior_transformer import (
    PriorConfig, PriorTransformer, prior_normalize_embeds,
    prior_post_process_latents,
)

from _torch_common import TINY, TOL, n, port_config, prior_pair, t

FIELDS = [f.name for f in dataclasses.fields(schedules.NoiseSchedule)]


def _same_schedule(got, want):
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype == np.float32, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name


@pytest.mark.parametrize("kind,prediction_type", [
    ("scaled_linear", "epsilon"), ("squaredcos_cap_v2", "sample"),
    ("squaredcos_cap_v2", "v_prediction"), ("linear", "epsilon")])
def test_make_schedule_matches_jax(kind, prediction_type):
    _same_schedule(schedules.make_schedule(kind, 1000, prediction_type),
                   j_schedules.make_schedule(kind, 1000, prediction_type))


def test_named_schedules_match_jax():
    _same_schedule(schedules.prior_schedule(), j_schedules.prior_schedule())
    _same_schedule(schedules.sd21_schedule(), j_schedules.sd21_schedule())
    np.testing.assert_array_equal(schedules.squaredcos_cap_v2_betas(50),
                                  j_schedules.squaredcos_cap_v2_betas(50))
    with pytest.raises(ValueError):
        schedules.make_schedule("cosine")


@pytest.mark.parametrize("steps", [1, 2, 20, 25])
def test_unclip_tables_match_jax(steps):
    np.testing.assert_array_equal(unclip.unclip_timesteps(1000, steps),
                                  j_unclip.unclip_timesteps(1000, steps))
    got = unclip.unclip_step_tables(schedules.prior_schedule(), steps)
    want = j_unclip.unclip_step_tables(j_schedules.prior_schedule(), steps)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == (steps,)
        np.testing.assert_array_equal(g, w)
    ts, _, _, std = got
    if steps == 1:
        # one step from t = 999 onto the final sample: the variance is 0,
        # floored at 1e-20 before the square root, and t > 0 keeps it
        assert ts[0] == 999 and std[0] == np.float32(1e-10)
    else:
        # no noise onto t = 0
        assert ts[-1] == 0 and std[-1] == 0.0 and (std[:-1] > 0).all()


def test_unclip_clip_x0_matches_jax():
    x = np.linspace(-30, 30, 61, dtype=np.float32)
    np.testing.assert_array_equal(n(unclip.unclip_clip_x0(t(x))),
                                  n(j_unclip.unclip_clip_x0(x)))


def _prior_inputs(b, doubled, seed=3):
    rng = np.random.default_rng(seed)
    rows = 2 * b if doubled else b
    return dict(
        noisy=rng.standard_normal((rows, 16)).astype(np.float32),
        ts=rng.integers(0, 1000, rows).astype(np.int32),
        proj=rng.standard_normal((rows, 16)).astype(np.float32),
        s_pose=rng.uniform(0, 1, (b, 36)).astype(np.float32),
        t_pose=rng.uniform(0, 1, (b, 36)).astype(np.float32))


@pytest.mark.parametrize("cfg_zero_cond", [False, True])
def test_prior_matches_jax(cfg_zero_cond):
    params, model = prior_pair(TINY.prior, 21)
    x = _prior_inputs(3, cfg_zero_cond)
    want = prior_apply(params, TINY.prior, x["noisy"], x["ts"], x["proj"],
                       x["s_pose"], x["t_pose"], cfg_zero_cond=cfg_zero_cond)
    with torch.no_grad():
        got = model(t(x["noisy"]), t(x["ts"]), t(x["proj"]), t(x["s_pose"]),
                    t(x["t_pose"]), cfg_zero_cond=cfg_zero_cond)
    assert got.shape == want.shape == (x["noisy"].shape[0], 16)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_prior_weights_carried_both_ways():
    """JAX -> port by ``prior_state_dict``; port -> JAX by the JAX
    package's ``convert_prior`` of the port's ``state_dict``: the same
    leaves, exactly."""
    params, model = prior_pair(TINY.prior, 22)
    sd = model.state_dict()
    assert set(sd) == set(prior_state_dict(params))
    back = convert_prior({k: v.numpy() for k, v in sd.items()})
    got, want = jax.tree.leaves(back), jax.tree.leaves(params)
    assert (jax.tree.structure(back) == jax.tree.structure(params))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_full_prior_config_matches_jax():
    """The full PriorConfig(): the same config fields, and the same
    parameter count as ``prior_init``'s (built on the meta device, by
    shapes only)."""
    assert dataclasses.asdict(PriorConfig()) == dataclasses.asdict(
        JPriorConfig())
    assert port_config(JPriorConfig(), PriorConfig) == PriorConfig()
    with torch.device("meta"):
        model = PriorTransformer()
    shapes = jax.eval_shape(lambda k: prior_init(k, JPriorConfig()),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    got = sum(p.numel() for p in model.parameters())
    assert got == want and 0.95e9 < got < 1.05e9


def test_post_process_and_normalize_match_jax():
    x = np.random.default_rng(4).standard_normal((2, 16)).astype(np.float32)
    np.testing.assert_array_equal(n(prior_post_process_latents(t(x))),
                                  n(j_post_process(x)))
    np.testing.assert_array_equal(n(prior_normalize_embeds(t(x))),
                                  n(j_normalize(x)))
