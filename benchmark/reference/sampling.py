"""Plain reference of the PCDMs samplers: the SD-2.1 noise schedule, UniPC
(order 2, bh2, predict-x0, the diffusers ``UniPCMultistepScheduler``
defaults), classifier-free guidance, and the stage-2 / stage-3 generation
of one request, in float32 with TF32 off.

Written from the published equations (Zhao et al. 2023, "UniPC"; diffusers'
scheduler), independent of the program under test.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def sd21_alphas_cumprod() -> np.ndarray:
    """Scaled-linear betas 0.00085 -> 0.012 over 1000 steps (f64), the
    cumulative product stored in f32."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000,
                        dtype=np.float64) ** 2
    return np.asarray(np.cumprod(1.0 - betas), np.float32)


def unipc_tables(num_steps: int):
    """Per-step host scalars of UniPC-bh2 with the final sigma at 0 and
    lower-order final steps: the model timesteps and, per step, the
    predictor's and corrector's coefficients."""
    ac = sd21_alphas_cumprod()
    ts = np.linspace(0, 999, num_steps + 1).round()[::-1][:-1].astype(
        np.int64)
    a64 = np.asarray(ac, np.float64)
    alpha, sigma = np.sqrt(a64[ts]), np.sqrt(1.0 - a64[ts])
    lam = np.log(alpha / sigma)
    lam_next = np.concatenate([lam[1:], [lam[-1] + 50.0]])
    alpha_next = np.concatenate([alpha[1:], [1.0]])
    sigma_next = np.concatenate([sigma[1:], [0.0]])
    lam_prev = np.concatenate([[lam[0]], lam[:-1]])
    lam_prev2 = np.concatenate([[lam[0]], lam_prev[:-1]])
    sigma_prev = np.concatenate([[sigma[0]], sigma[:-1]])
    idx = np.arange(num_steps)
    p_order = np.minimum(np.minimum(2, idx + 1), num_steps - idx)
    c_order = np.concatenate([[1], p_order[:-1]])
    p_h = lam_next - lam
    c_h = lam - lam_prev
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        ts=ts, ac=ac,
        p_h=f32(p_h), p_r0=f32((lam_prev - lam) / p_h),
        p_ratio=f32(sigma_next / sigma), p_alpha=f32(alpha_next),
        p_order2=p_order >= 2,
        c_h=f32(c_h), c_r0=f32((lam_prev2 - lam_prev)
                               / np.where(c_h == 0, 1.0, c_h)),
        c_ratio=f32(sigma / sigma_prev), c_alpha=f32(alpha),
        c_order2=c_order >= 2)


def _b(h):
    hh = -h
    phi = np.expm1(hh)
    return phi, (phi / hh - 1.0) / phi, ((phi / hh - 1.0) / hh - 0.5) * 2.0 / phi


def unipc(model_x0, x, num_steps: int):
    """UniPC-bh2 from x at t = 999 down to sigma = 0; ``model_x0(x, t)``
    gives the guided x0 estimate."""
    tb = unipc_tables(num_steps)
    m1 = m2 = last = None
    for i in range(num_steps):
        m = model_x0(x, int(tb["ts"][i]))
        if i > 0:
            h = tb["c_h"][i]
            phi, b1, b2 = _b(h)
            xt = float(tb["c_ratio"][i]) * last - float(
                tb["c_alpha"][i] * phi) * m1
            if tb["c_order2"][i]:
                r0 = tb["c_r0"][i]
                rho0 = (b2 - b1) / (r0 - np.float32(1.0))
                rho1 = b1 - rho0
                d1 = (m2 - m1) / float(r0)
                x = xt - float(tb["c_alpha"][i] * phi) * (
                    float(rho0) * d1 + float(rho1) * (m - m1))
            else:
                x = xt - float(tb["c_alpha"][i] * phi) * (0.5 * (m - m1))
        h = tb["p_h"][i]
        phi, _, _ = _b(h)
        x_next = float(tb["p_ratio"][i]) * x - float(
            tb["p_alpha"][i] * phi) * m
        if tb["p_order2"][i]:
            d1 = (m1 - m) / float(tb["p_r0"][i])
            x_next = x_next - float(tb["p_alpha"][i] * phi
                                    * np.float32(0.5)) * d1
        m2, m1, last, x = m1, m, x, x_next
    return x


def guided_x0(unet, make_input, ctx, guidance: float, **cond):
    """model_x0(x, t) over a CFG-doubled batch [uncond; cond]."""
    ac = sd21_alphas_cumprod()

    def model_x0(x, t):
        inp = make_input(torch.cat([x, x]))
        tt = torch.full((inp.shape[0],), float(t), device=x.device)
        eps = unet(inp, tt, ctx, **cond).float()
        u, c = eps.chunk(2)
        eps = u + guidance * (c - u)
        a = float(np.sqrt(ac[t]))
        s = float(np.sqrt(np.float32(1.0) - ac[t]))
        return (x - s * eps) / a

    return model_x0


@contextlib.contextmanager
def full_f32():
    """Matmuls and convolutions in full float32 (TF32 off) inside the
    block; the caller's settings come back after it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(prev)


def half_mask(h: int, w: int, device):
    m = torch.zeros((1, h, w, 1), device=device)
    m[:, :, :w // 2] = 1.0
    return m


@torch.no_grad()
def stage2_one(nets, row: dict, latents, num_steps: int, guidance: float):
    """One stage-2 request: ``row`` holds vae_image / st_pose (1, H, 2W, 3),
    dino (1, 257, 1536), embed (1, 1, 1024); ``latents`` (1, H/8, 2W/8, 4).
    Returns the decoded (1, H, 2W, 3) image."""
    proj = nets["image_proj"](row["dino"])
    embed = row["embed"].float()
    feat = torch.cat([proj, embed], dim=1)
    cls = embed[:, 0]
    pose = nets["pose_proj"](row["st_pose"])
    masked = nets["vae"].encode_mean(row["vae_image"])
    lh, lw = masked.shape[1:3]
    mask = half_mask(lh, lw, masked.device)
    ctx = torch.cat([torch.zeros_like(feat), feat])
    cond = dict(class_labels=torch.cat([torch.zeros_like(cls), cls]),
                pose=torch.cat([pose, pose]))
    fixed = torch.cat([torch.cat([mask, masked], dim=-1)] * 2)

    def make_input(x2):
        return torch.cat([x2, fixed], dim=-1)

    x0 = unipc(guided_x0(nets["unet"], make_input, ctx, guidance, **cond),
               latents.float(), num_steps)
    return nets["vae"].decode(x0)


@torch.no_grad()
def stage3_one(nets, row: dict, latents, num_steps: int, guidance: float):
    """One stage-3 request: ``row`` holds gen_image (1, H, W, 3) and dino
    (1, 257, 1536). Returns the decoded (1, H, W, 3) image."""
    feat = nets["image_proj"](row["dino"])
    gen = nets["vae"].encode_mean(row["gen_image"])
    ctx = torch.cat([torch.zeros_like(feat), feat])
    fixed = torch.cat([torch.zeros_like(gen), gen])

    def make_input(x2):
        return torch.cat([x2, fixed], dim=-1)

    x0 = unipc(guided_x0(nets["unet"], make_input, ctx, guidance),
               latents.float(), num_steps)
    return nets["vae"].decode(x0)
