"""Noise schedules as precomputed coefficient tables (counterpart of
``pcdms_tpu/diffusion/schedules.py``, a jax-free copy: the tables are numpy
there too, but that module imports ``jax.numpy``).

  * scaled_linear (SD-2.1): stage-2 / stage-3 DDIM and UniPC
  * linear: diffusers' default DDPM betas
  * squaredcos_cap_v2 with prediction_type='sample': the stage-1 prior's
    UnCLIP sampler

The betas are computed in float64 and the tables stored in float32, as the
JAX package stores them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def scaled_linear_betas(num_train_timesteps: int = 1000,
                        beta_start: float = 0.00085,
                        beta_end: float = 0.012) -> np.ndarray:
    return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                       num_train_timesteps, dtype=np.float64) ** 2


def linear_betas(num_train_timesteps: int = 1000,
                 beta_start: float = 0.0001,
                 beta_end: float = 0.02) -> np.ndarray:
    return np.linspace(beta_start, beta_end, num_train_timesteps,
                       dtype=np.float64)


def squaredcos_cap_v2_betas(num_train_timesteps: int = 1000,
                            max_beta: float = 0.999) -> np.ndarray:
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    T = num_train_timesteps
    betas = [min(1.0 - alpha_bar((i + 1) / T) / alpha_bar(i / T), max_beta)
             for i in range(T)]
    return np.array(betas, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Precomputed diffusion coefficient tables, host (numpy float32)
    arrays."""
    betas: np.ndarray
    alphas: np.ndarray
    alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    num_train_timesteps: int
    prediction_type: str = "epsilon"   # 'epsilon' | 'sample' | 'v_prediction'


def make_schedule(kind: str = "scaled_linear",
                  num_train_timesteps: int = 1000,
                  prediction_type: str = "epsilon",
                  **kwargs) -> NoiseSchedule:
    if kind == "scaled_linear":
        betas = scaled_linear_betas(num_train_timesteps, **kwargs)
    elif kind == "linear":
        betas = linear_betas(num_train_timesteps, **kwargs)
    elif kind == "squaredcos_cap_v2":
        betas = squaredcos_cap_v2_betas(num_train_timesteps, **kwargs)
    else:
        raise ValueError(f"unknown beta schedule: {kind}")
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    return NoiseSchedule(
        betas=np.asarray(betas, np.float32),
        alphas=np.asarray(alphas, np.float32),
        alphas_cumprod=np.asarray(ac, np.float32),
        sqrt_alphas_cumprod=np.asarray(np.sqrt(ac), np.float32),
        sqrt_one_minus_alphas_cumprod=np.asarray(np.sqrt(1.0 - ac),
                                                 np.float32),
        num_train_timesteps=num_train_timesteps,
        prediction_type=prediction_type,
    )


def sd21_schedule(prediction_type: str = "epsilon") -> NoiseSchedule:
    """The SD-2.1-base scheduler config (beta 0.00085 -> 0.012, scaled
    linear, 1000 steps) used for stage-2/3 training and inference."""
    return make_schedule("scaled_linear", 1000, prediction_type)


def prior_schedule() -> NoiseSchedule:
    """The stage-1 prior's: squaredcos_cap_v2, prediction_type='sample'."""
    return make_schedule("squaredcos_cap_v2", 1000, "sample")


def pred_to_x0(model_out, x_t, sqrt_ac_t, sqrt_1mac_t, prediction_type: str):
    """Convert a model output to an x0 estimate at timestep t.

    sqrt_ac_t / sqrt_1mac_t must broadcast against x_t.
    """
    if prediction_type == "epsilon":
        return (x_t - sqrt_1mac_t * model_out) / sqrt_ac_t
    if prediction_type == "sample":
        return model_out
    if prediction_type == "v_prediction":
        return sqrt_ac_t * x_t - sqrt_1mac_t * model_out
    raise ValueError(prediction_type)


def pred_to_eps(model_out, x_t, sqrt_ac_t, sqrt_1mac_t, prediction_type: str):
    """Convert a model output to an epsilon estimate at timestep t."""
    if prediction_type == "epsilon":
        return model_out
    if prediction_type == "sample":
        return (x_t - sqrt_ac_t * model_out) / sqrt_1mac_t
    if prediction_type == "v_prediction":
        return sqrt_1mac_t * x_t + sqrt_ac_t * model_out
    raise ValueError(prediction_type)
