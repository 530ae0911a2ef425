"""Profiling helpers (counterpart of ``pcdms_tpu/utils/profiling.py``): a
``torch.profiler`` trace, ``sync``, a throughput meter and a timer."""

from __future__ import annotations

import contextlib
import os
import time

import torch


def start_trace(cuda: bool):
    """A started ``torch.profiler`` of the CPU and, with ``cuda``, the card."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, log_dir: str) -> str:
    """Stop ``prof`` and write its chrome trace (TensorBoard / Perfetto) to
    ``<log_dir>/trace.json``; returns that path."""
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA when the card is there) and write a
    chrome trace to ``<log_dir>/trace.json``."""
    prof = start_trace(torch.cuda.is_available())
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir)


def sync(x: torch.Tensor) -> float:
    """Wait for the device, then read one reduced scalar of ``x`` back to
    the host; returns it. Host clocks around a call that ends in ``sync``
    measure the device's work, not the enqueue."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(x.float().sum())


class ThroughputMeter:
    """Examples per second since the last ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._count = 0

    def update(self, n_examples: int):
        self._count += n_examples

    def rate(self) -> float:
        return self._count / max(time.perf_counter() - self._t0, 1e-9)

    def rate_per_device(self) -> float:
        return self.rate() / max(1, torch.cuda.device_count())


def timed(fn, *args, sync_output: bool = True, **kwargs):
    """One call of ``fn``; returns (result, seconds). With ``sync_output``
    the time includes the device's work on the first tensor of the result
    (``sync``)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if sync_output:
        leaf = out
        while isinstance(leaf, (tuple, list, dict)):
            leaf = next(iter(leaf.values() if isinstance(leaf, dict)
                             else leaf))
        sync(leaf)
    return out, time.perf_counter() - t0
