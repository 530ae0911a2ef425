"""Synchronisation helper (counterpart of ``sync`` in
``pcdms_tpu/utils/profiling.py``)."""

from __future__ import annotations

import torch


def sync(x: torch.Tensor) -> float:
    """Wait for the device, then read one reduced scalar of ``x`` back to
    the host; returns it. Host clocks around a call that ends in ``sync``
    measure the device's work, not the enqueue."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(x.float().sum())
