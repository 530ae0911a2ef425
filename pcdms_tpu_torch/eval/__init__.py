"""Evaluation: the metric networks and the host metrics of the protocol.

``f32_convs`` is the precision policy of both metric networks
(``inception.py``, ``lpips.py``): their forwards run in f32 whoever calls
them, so the features do not depend on the caller's cuDNN setting.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_convs():
    """cuDNN convolutions in full f32 (TF32 off) inside the block; the
    caller's setting is restored after it.

    ``torch.backends.cudnn.allow_tf32`` is process-global, so this is not
    thread-safe: a convolution that another thread of the process runs
    inside the block (a serving engine, say) runs without TF32 too, and two
    such blocks that overlap on two threads can restore each other's
    setting out of order."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
