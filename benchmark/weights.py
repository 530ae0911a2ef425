"""Weights and inputs made from the run's seed, on the device.

Every parameter of a network is drawn from one ``torch.Generator`` on the
device in a few large calls (one flat buffer of standard normals, drawn in
f32 chunks and rounded once to the served dtype), then scaled in place: a
weight of fan-in n by 1/sqrt(n), a normalisation's scale to 1 + 0.05 z,
a bias to 0.02 z. The names and shapes come from the plain reference
(``reference/nets.py``), so the program and the reference get the same
tensors under the same names; the reference reads them in f32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

_CHUNK = 1 << 26


def derive_seed(*parts: int) -> int:
    """A 63-bit seed from any whole numbers (numpy's SeedSequence)."""
    state = np.random.SeedSequence([int(p) for p in parts]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def specs(module: torch.nn.Module) -> List[Tuple[str, tuple]]:
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


def draw(spec: List[Tuple[str, tuple]], seed: int, device,
         dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """{name: tensor} in ``dtype`` on ``device``, views of one buffer."""
    total = sum(math.prod(s) for _, s in spec)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for a in range(0, total, _CHUNK):
        b = min(total, a + _CHUNK)
        flat[a:b] = torch.randn(b - a, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if len(shape) >= 2:
            t.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
        elif name.endswith("weight"):
            t.mul_(0.05).add_(1.0)
        else:
            t.mul_(0.02)
        out[name] = t
    return out


def install(module: torch.nn.Module, tensors: Dict[str, torch.Tensor],
            requires_grad: bool = False) -> torch.nn.Module:
    """Put ``tensors`` into ``module`` (built on the meta device) as its
    parameters, by name. The names must match exactly."""
    own = {n for n, _ in module.named_parameters()}
    if own != set(tensors):
        raise ValueError(
            f"parameter names differ: only in the module "
            f"{sorted(own - set(tensors))[:5]}, only drawn "
            f"{sorted(set(tensors) - own)[:5]}")
    for name, t in tensors.items():
        *path, leaf = name.split(".")
        sub = module.get_submodule(".".join(path))
        if tuple(getattr(sub, leaf).shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} vs "
                             f"{tuple(getattr(sub, leaf).shape)}")
        setattr(sub, leaf, torch.nn.Parameter(t, requires_grad=requires_grad))
    left = [n for n, b in module.named_buffers() if b.is_meta]
    if left:
        raise ValueError(f"buffers left on the meta device: {left[:5]}")
    return module
