"""The VAE pre-training loss (``train/vae.py``) against the JAX package's
``vae_pretrain_loss_fn``, f32 on the CPU with its draw injected: the loss,
its MSE and KL terms and every parameter's gradient, on a two-level tiny
VAE (a short JAX compile). Bar: f32 atol 1e-4, rtol 1e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdms_tpu.compat.torch_convert import convert_vae
from pcdms_tpu.train.vae import vae_pretrain_loss_fn as j_vae_loss_fn

from pcdms_tpu_torch.compat.from_jax import vae_state_dict
from pcdms_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from pcdms_tpu_torch.train.vae import vae_draws, vae_pretrain_loss

from _torch_common import TINY, TOL, from_torch, n, one_thread, port_config, t

VAE = dataclasses.replace(TINY.vae, block_out_channels=(4, 8))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def test_vae_loss_and_grads_match_jax():
    torch.manual_seed(40)
    jv, tv = from_torch(AutoencoderKL(port_config(VAE, VAEConfig)),
                        convert_vae, 40)
    rng = np.random.default_rng(6)
    image = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    loss_fn = j_vae_loss_fn(VAE, kl_weight=1e-2)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, jv), {"image": jnp.asarray(image)}, key)
    noise = jax.random.normal(key, (2, 16, 16, 4), jnp.float32)
    loss, m = vae_pretrain_loss(tv, {"image": t(image)},
                                {"noise": t(np.asarray(noise))},
                                kl_weight=1e-2)
    loss.backward()
    for k, want in (("loss", jloss), ("mse", jm["mse"]), ("kl", jm["kl"])):
        np.testing.assert_allclose(float(m[k]), float(want), **TOL,
                                   err_msg=k)
    want = vae_state_dict(jax.tree.map(np.asarray, jgrads))
    got = dict(tv.named_parameters())
    assert set(want) == set(got)
    for k, g in want.items():
        np.testing.assert_allclose(n(got[k].grad), g, **TOL, err_msg=k)
    d = vae_draws(torch.Generator().manual_seed(0), 3, (4, 5))
    assert d["noise"].shape == (3, 4, 5, 4)
