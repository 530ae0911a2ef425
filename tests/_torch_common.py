"""Shared helpers for the ``test_torch_*`` parity tests: random JAX
parameter pytrees made non-zero everywhere, and the port's modules built
from them through ``pcdms_tpu_torch.compat.from_jax``."""

import contextlib
import dataclasses

import jax
import numpy as np
import torch

from pcdms_tpu.cli.common import tiny_configs
from pcdms_tpu.models.prior_transformer import prior_init
from pcdms_tpu.models.projections import (
    image_proj_mlp_init, pose_cond_embedding_init,
)
from pcdms_tpu.models.unet2d import unet_init
from pcdms_tpu.models.vae import vae_init
from pcdms_tpu.models.vit import vit_init

from pcdms_tpu_torch.compat.from_jax import (
    image_proj_state_dict, load_numpy_state_dict, pose_proj_state_dict,
    prior_state_dict, unet_state_dict, vae_state_dict, vit_state_dict,
)
from pcdms_tpu_torch.models.prior_transformer import (
    PriorConfig as TPriorConfig, PriorTransformer,
)
from pcdms_tpu_torch.models.projections import (
    ImageProjModel, PoseCondEmbedding,
)
from pcdms_tpu_torch.models.unet2d import (
    UNet2DConditionModel, UNetConfig as TUNetConfig,
)
from pcdms_tpu_torch.models.vae import AutoencoderKL, VAEConfig as TVAEConfig
from pcdms_tpu_torch.models.vit import (
    ViTConfig as TViTConfig, VisionTransformer,
)

TOL = dict(atol=1e-4, rtol=1e-3)
TINY = tiny_configs()


def nonzero(tree, seed: int, scale: float = 0.05):
    """Every leaf as f32 numpy plus seeded noise: no weight stays zero
    (the pose encoder's zero-initialised conv_out would hide the pose path,
    zero norm biases would hide their wiring)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x, np.float32) + scale * rng.standard_normal(
            np.shape(x)).astype(np.float32)), tree)


def port_config(cfg, cls):
    return cls(**dataclasses.asdict(cfg))


def unet_pair(cfg, seed: int):
    """(JAX params, port UNet) with the same non-zero random weights."""
    params = nonzero(unet_init(jax.random.PRNGKey(seed), cfg), seed)
    model = UNet2DConditionModel(port_config(cfg, TUNetConfig))
    load_numpy_state_dict(model, unet_state_dict(params))
    return params, model.eval()


def vae_pair(cfg, seed: int):
    params = nonzero(vae_init(jax.random.PRNGKey(seed), cfg), seed)
    model = AutoencoderKL(port_config(cfg, TVAEConfig))
    load_numpy_state_dict(model, vae_state_dict(params))
    return params, model.eval()


def image_proj_pair(seed: int, **kwargs):
    params = nonzero(image_proj_mlp_init(jax.random.PRNGKey(seed), **kwargs),
                     seed)
    model = ImageProjModel(**kwargs)
    load_numpy_state_dict(model, image_proj_state_dict(params))
    return params, model.eval()


def pose_proj_pair(seed: int, **kwargs):
    params = nonzero(
        pose_cond_embedding_init(jax.random.PRNGKey(seed), **kwargs), seed)
    model = PoseCondEmbedding(**kwargs)
    load_numpy_state_dict(model, pose_proj_state_dict(params))
    return params, model.eval()


def prior_pair(cfg, seed: int):
    """(JAX params, port PriorTransformer) with the same non-zero random
    weights (the zero positional and prd embeddings made non-zero too)."""
    params = nonzero(prior_init(jax.random.PRNGKey(seed), cfg), seed)
    model = PriorTransformer(port_config(cfg, TPriorConfig))
    load_numpy_state_dict(model, prior_state_dict(params))
    return params, model.eval()


def vit_pair(cfg, seed: int):
    """(JAX params, port VisionTransformer) with the same non-zero random
    weights."""
    params = nonzero(vit_init(jax.random.PRNGKey(seed), cfg), seed)
    model = VisionTransformer(port_config(cfg, TViTConfig))
    load_numpy_state_dict(model, vit_state_dict(params, cfg))
    return params, model.eval()


def from_torch(module, convert, seed: int, scale: float = 0.05):
    """(JAX params, ``module``): the module's torch init plus seeded noise
    (no weight stays zero), carried to the JAX layout by ``convert`` (a
    ``pcdms_tpu/compat/torch_convert.py`` function). No JAX init runs, which
    keeps a test off the XLA compiles of the JAX initialisers."""
    rng = np.random.default_rng(seed)
    sd = {k: v.detach().float().numpy() + scale * rng.standard_normal(
        v.shape).astype(np.float32) for k, v in module.state_dict().items()}
    load_numpy_state_dict(module, sd)
    return convert(sd), module.eval()


def t(x):
    """numpy -> CPU torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(x))


def n(x):
    """torch tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def stage2_batch(b, h, w2, seed=0):
    """A stage-2 training batch of numpy arrays at the tiny conditioning
    widths (5 DINOv2 tokens of 24, CLIP embedding of 16)."""
    rng = np.random.default_rng(seed)
    return {
        "st_image": rng.uniform(-1, 1, (b, h, w2, 3)).astype(np.float32),
        "masked_image": rng.uniform(-1, 1, (b, h, w2, 3)).astype(np.float32),
        "pose_image": rng.uniform(-1, 1, (b, h, w2, 3)).astype(np.float32),
        "dino_features": rng.standard_normal((b, 5, 24)).astype(np.float32),
        "clip_embed": rng.standard_normal((b, 1, 16)).astype(np.float32),
    }


def stage2_models(unet_cfg, seed):
    """(JAX trainable params, JAX vae params, port trainable modules, port
    vae) with the same non-zero weights."""
    ju, tu = unet_pair(unet_cfg, seed)
    jv, tv = vae_pair(TINY.vae, seed + 1)
    ji, ti = image_proj_pair(seed + 2, **TINY.image_proj_kwargs)
    jp, tp = pose_proj_pair(seed + 3, **TINY.pose_proj_kwargs)
    return ({"unet": ju, "image_proj": ji, "pose_proj": jp}, jv,
            {"unet": tu, "image_proj": ti, "pose_proj": tp}, tv)


@contextlib.contextmanager
def one_thread():
    """Run tiny models on one intra-op thread: on them torch's default of a
    thread per core spends more CPU waiting than computing, which the other
    test workers pay for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
