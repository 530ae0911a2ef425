"""UniPC multistep predictor-corrector sampler (order <= 2, bh2,
predict-x0), counterpart of ``pcdms_tpu/diffusion/unipc.py``.

diffusers ``UniPCMultistepScheduler`` defaults: solver_order=2,
predict_x0=True, solver_type='bh2', corrector on, lower_order_final=True,
'linspace' spacing, final sigma zero. The coefficient tables are a jax-free
copy of the JAX package's; the loop is a plain Python loop that carries
(m_prev, m_prev2, last_sample) and evaluates only the order each step uses.
Per-step scalars stay float32 (numpy), as on the JAX side.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from pcdms_tpu_torch.diffusion.schedules import NoiseSchedule

_LAMBDA_FINAL_BUMP = 50.0   # lambda at sigma=0 is +inf; +50 saturates expm1


def unipc_timesteps(num_train_timesteps: int,
                    num_inference_steps: int) -> np.ndarray:
    """'linspace' spacing (the 'leading' option is not ported)."""
    T, N = num_train_timesteps, num_inference_steps
    return np.linspace(0, T - 1, N + 1).round()[::-1][:-1].astype(np.int64)


@dataclasses.dataclass(frozen=True)
class UniPCCoeffs:
    """Per-step host (numpy) arrays, all of length N (step index i goes
    t_i -> t_{i+1}; the final target is sigma=0)."""
    timesteps: np.ndarray        # (N,) int32 — model eval times t_i
    # predictor: from t_i to t_{i+1}
    p_h: np.ndarray              # lambda(t_{i+1}) - lambda(t_i)
    p_r0: np.ndarray             # (lambda(t_{i-1}) - lambda(t_i)) / p_h
    p_sigma_ratio: np.ndarray    # sigma(t_{i+1}) / sigma(t_i)
    p_alpha: np.ndarray          # alpha(t_{i+1})
    p_order2: np.ndarray         # bool: use order-2 predictor
    # corrector: refines x at t_i using last_sample at t_{i-1}
    c_h: np.ndarray              # lambda(t_i) - lambda(t_{i-1})
    c_r0: np.ndarray             # (lambda(t_{i-2}) - lambda(t_{i-1})) / c_h
    c_sigma_ratio: np.ndarray    # sigma(t_i) / sigma(t_{i-1})
    c_alpha: np.ndarray          # alpha(t_i)
    c_order2: np.ndarray         # bool: use order-2 corrector
    c_enabled: np.ndarray        # bool: corrector active (i > 0)


def unipc_coeffs(schedule: NoiseSchedule,
                 num_inference_steps: int) -> UniPCCoeffs:
    N = num_inference_steps
    ts = unipc_timesteps(schedule.num_train_timesteps, N)
    ac = np.asarray(schedule.alphas_cumprod, np.float64)

    alpha = np.sqrt(ac[ts])
    sigma = np.sqrt(1.0 - ac[ts])
    lam = np.log(alpha / sigma)

    # final target: sigma = 0 (alpha = 1)
    alpha_next = np.concatenate([alpha[1:], [1.0]])
    sigma_next = np.concatenate([sigma[1:], [0.0]])
    lam_next = np.concatenate([lam[1:], [lam[-1] + _LAMBDA_FINAL_BUMP]])

    lam_older = np.concatenate([[lam[0]], lam[:-1]])      # lambda(t_{i-1})
    lam_older2 = np.concatenate([[lam[0]], lam_older[:-1]])  # lambda(t_{i-2})

    p_h = lam_next - lam
    p_r0 = np.where(p_h != 0, (lam_older - lam) / np.where(p_h == 0, 1, p_h),
                    1.0)
    p_sigma_ratio = np.where(sigma > 0, sigma_next / np.where(sigma == 0, 1,
                                                              sigma), 0.0)

    c_h = lam - lam_older
    c_h_safe = np.where(c_h == 0, 1.0, c_h)
    c_r0 = (lam_older2 - lam_older) / c_h_safe
    sigma_older = np.concatenate([[sigma[0]], sigma[:-1]])
    c_sigma_ratio = sigma / sigma_older

    idx = np.arange(N)
    # predictor order at step i: min(2, i+1) with lower_order_final
    p_order = np.minimum(np.minimum(2, idx + 1), N - idx)
    # corrector order at step i = predictor order at step i-1
    c_order = np.concatenate([[1], p_order[:-1]])

    return UniPCCoeffs(
        timesteps=np.asarray(ts, np.int32),
        p_h=np.asarray(p_h, np.float32),
        p_r0=np.asarray(p_r0, np.float32),
        p_sigma_ratio=np.asarray(p_sigma_ratio, np.float32),
        p_alpha=np.asarray(alpha_next, np.float32),
        p_order2=np.asarray(p_order >= 2),
        c_h=np.asarray(c_h, np.float32),
        c_r0=np.asarray(c_r0, np.float32),
        c_sigma_ratio=np.asarray(c_sigma_ratio, np.float32),
        c_alpha=np.asarray(alpha[np.arange(N)], np.float32),
        c_order2=np.asarray(c_order >= 2),
        c_enabled=np.asarray(idx > 0),
    )


def _bh2_b(h):
    """b1, b2 of the bh2 variant (B_h = expm1(hh), hh = -h, predict_x0)."""
    hh = -h
    h_phi_1 = np.expm1(hh)
    B_h = h_phi_1
    b1 = (h_phi_1 / hh - 1.0) / B_h
    b2 = ((h_phi_1 / hh - 1.0) / hh - 0.5) * 2.0 / B_h
    return h_phi_1, B_h, b1, b2


def _predictor(x, m0, m1, h, r0, sigma_ratio, alpha_t, order2):
    h_phi_1, B_h, _, _ = _bh2_b(h)
    x_t = float(sigma_ratio) * x - float(alpha_t * h_phi_1) * m0
    if not order2:
        return x_t
    d1 = (m1 - m0) / float(r0 if r0 != 0 else np.float32(1.0))
    return x_t - float(alpha_t * B_h * np.float32(0.5)) * d1


def _corrector(last_x, m0, m1, m_t, h, r0, sigma_ratio, alpha_t, order2):
    h_phi_1, B_h, b1, b2 = _bh2_b(h)
    x_t_ = float(sigma_ratio) * last_x - float(alpha_t * h_phi_1) * m0
    d1_t = m_t - m0
    if not order2:
        # order 1: rhos_c = [0.5]
        return x_t_ - float(alpha_t * B_h) * (0.5 * d1_t)
    # order 2: solve [[1,1],[r0,1]] rhos = [b1,b2]
    denom = np.float32(1e-8) if r0 == 1.0 else r0 - np.float32(1.0)
    rho0 = (b2 - b1) / denom
    rho1 = b1 - rho0
    d1 = (m1 - m0) / float(r0 if r0 != 0 else np.float32(1.0))
    return x_t_ - float(alpha_t * B_h) * (float(rho0) * d1
                                          + float(rho1) * d1_t)


def unipc_sample(schedule: NoiseSchedule, model_x0_fn: Callable,
                 x_init, num_inference_steps: int):
    """Run the UniPC loop. ``model_x0_fn(x, t) -> x0`` at integer timestep
    t (the caller folds CFG and eps -> x0 into it). Returns the final
    sample (x0 domain)."""
    co = unipc_coeffs(schedule, num_inference_steps)
    x = x_init
    m_prev = m_prev2 = last_x = None
    for i in range(num_inference_steps):
        m_t = model_x0_fn(x, int(co.timesteps[i]))
        if co.c_enabled[i]:
            x = _corrector(last_x, m_prev, m_prev2, m_t, co.c_h[i],
                           co.c_r0[i], co.c_sigma_ratio[i], co.c_alpha[i],
                           co.c_order2[i])
        x_next = _predictor(x, m_t, m_prev, co.p_h[i], co.p_r0[i],
                            co.p_sigma_ratio[i], co.p_alpha[i],
                            co.p_order2[i])
        m_prev2, m_prev, last_x, x = m_prev, m_t, x, x_next
    return x
