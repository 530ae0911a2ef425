"""Latent-consistency distillation (counterpart of
``pcdms_tpu/train/lcm_distill.py``). Only the boundary scalings are ported:
the LCM sampler (``pipelines/sampling.lcm_sample_loop``) wraps the student's
output in the same consistency parameterization it was distilled under.
The trainer itself is not ported yet.
"""

from __future__ import annotations

import torch


def lcm_boundary_scalings(t, sigma_data: float = 0.5,
                          timestep_scaling: float = 10.0):
    """c_skip / c_out of the consistency boundary condition (diffusers
    ``scalings_for_boundary_conditions``): c_skip(0) = 1, c_out(0) = 0, and
    c_skip ~ 0 away from t = 0. t: raw schedule timesteps (a number or a
    tensor); returns f32 tensors."""
    st = timestep_scaling * torch.as_tensor(t, dtype=torch.float32)
    c_skip = sigma_data ** 2 / (st ** 2 + sigma_data ** 2)
    c_out = st / torch.sqrt(st ** 2 + sigma_data ** 2)
    return c_skip, c_out
