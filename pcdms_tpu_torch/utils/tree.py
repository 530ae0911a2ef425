"""Dtype / device casting of modules and tensors, and parameter counts
(counterparts of ``cast_pytree``, ``param_count`` and ``param_bytes`` in
``pcdms_tpu/utils/tree.py``)."""

from __future__ import annotations

import copy
from typing import Any, Optional

import numpy as np
import torch


def _needs_cast(t: torch.Tensor, dtype, device) -> bool:
    return ((t.is_floating_point() and t.dtype != dtype)
            or (device is not None and t.device != device))


def cast_tree(tree: Any, dtype: torch.dtype,
              device: Optional[torch.device] = None) -> Any:
    """Cast every floating-point tensor of ``tree`` (a module, a tensor, or
    a dict of them) to ``dtype`` and, if given, ``device``.

    Unlike ``module.to``, this never mutates its input: a module whose
    tensors already match is returned as it is, any other is deep-copied
    first. So weights made in the compute dtype on the card cost no copy,
    and f32 master weights stay f32 for the caller, as the JAX pytrees do.
    """
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
        if not any(_needs_cast(t, dtype, device) for t in tensors):
            return tree
        out = copy.deepcopy(tree)
        if device is not None:
            out = out.to(device)
        return out.to(dtype)
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            return tree.to(device=device, dtype=dtype)
        return tree if device is None else tree.to(device)
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype, device) for k, v in tree.items()}
    return tree


def as_tensor(x, device) -> Optional[torch.Tensor]:
    """A numpy array or tensor on ``device`` (None passes through)."""
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def _tensors(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def param_count(tree) -> int:
    """Elements of every parameter (modules) or tensor in ``tree``."""
    return sum(t.numel() for t in _tensors(tree))


def param_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))
