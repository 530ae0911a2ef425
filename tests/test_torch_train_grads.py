"""The port's stage-2 loss and every trainable parameter's gradient
against ``jax.value_and_grad`` of the JAX package's ``stage2_loss_fn``, f32
on the CPU, with the JAX package's own draws injected: once with plain
attention and once with the flash Function inside a tiny UNet (512 tokens
at level 0). Both cases share one canvas, so JAX compiles its loss once.
Bar: f32 atol 1e-4, rtol 1e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdms_tpu.train.stage2 import stage2_loss_fn as j_stage2_loss_fn

from pcdms_tpu_torch.compat.from_jax import (
    image_proj_state_dict, pose_proj_state_dict, unet_state_dict,
)
from pcdms_tpu_torch.diffusion.schedules import sd21_schedule
from pcdms_tpu_torch.ops import flash_attention_bwd as fb
from pcdms_tpu_torch.train.stage2 import stage2_loss

from _torch_common import TINY, TOL, n, stage2_batch, stage2_models, t

STATE_DICTS = {"unet": unet_state_dict, "image_proj": image_proj_state_dict,
               "pose_proj": pose_proj_state_dict}
H, W2 = 128, 256            # 16 x 32 latents: 512 tokens at level 0


def _jax_draws(rng, b, lh, lw):
    """The JAX loss's draws (``pcdms_tpu/train/stage2.py:48-61``,
    ``models/vae.py:193-199``, ``diffusion/ddpm.py:37-52``) as numpy."""
    rng_v1, rng_v2, rng_noise, rng_off, rng_t = jax.random.split(rng, 5)
    shape = (b, lh, lw, 4)
    return {
        "vae_gt": jax.random.normal(rng_v1, shape, jnp.float32),
        "vae_masked": jax.random.normal(rng_v2, shape, jnp.float32),
        "noise": jax.random.normal(rng_noise, shape, jnp.float32),
        "offset": jax.random.normal(rng_off, (b, 1, 1, 4), jnp.float32),
        "timesteps": jax.random.randint(rng_t, (b,), 0, 1000),
    }



@pytest.fixture(scope="module")
def jax_case():
    """(JAX params, JAX vae, batch, rng, loss, grads), computed once: the
    JAX side takes plain attention on the CPU either way."""
    jparams, jvae, _, _ = stage2_models(TINY.unet2(True), 50)
    loss_fn = j_stage2_loss_fn(TINY.unet2(True), jvae, vae_cfg=TINY.vae,
                               noise_offset=0.1, compute_dtype=jnp.float32)
    batch = stage2_batch(2, H, W2)
    rng = jax.random.PRNGKey(7)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    return batch, rng, float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("use_flash", [False, True])
def test_stage2_loss_and_grads_match_jax(use_flash, monkeypatch, jax_case):
    """Loss and the gradient of every trainable parameter. With use_flash
    the level-0 self-attentions differentiate through the flash Function
    (its plain versions on the CPU)."""
    batch, rng, jloss, jgrads = jax_case
    cfg = dataclasses.replace(TINY.unet2(True), use_flash=use_flash)
    _, _, models, vae = stage2_models(cfg, 50)

    calls = []
    orig = fb.flash_fwd_lse_plain
    monkeypatch.setattr(fb, "flash_fwd_lse_plain",
                        lambda *a: calls.append(1) or orig(*a))
    draws = {k: t(np.asarray(v)) for k, v in
             _jax_draws(rng, 2, H // 8, W2 // 8).items()}
    loss = stage2_loss(models, vae, {k: t(v) for k, v in batch.items()},
                       draws, schedule=sd21_schedule(), noise_offset=0.1,
                       compute_dtype=torch.float32)
    loss.backward()
    # level 0: one down-block and two up-block transformers
    assert len(calls) == (3 if use_flash else 0)
    np.testing.assert_allclose(loss.item(), jloss, **TOL)
    for name, module in models.items():
        want = STATE_DICTS[name](jgrads[name])
        got = {k: p.grad for k, p in module.named_parameters()}
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k] is not None, k
            np.testing.assert_allclose(n(got[k]), want[k], err_msg=k, **TOL)
