"""The input pipeline (counterpart of ``pcdms_tpu/data/loader.py``): a
thread pool that decodes and composites examples while the device steps,
and ``prefetch_to_device``, which keeps the next batches' copies to the
card in flight.

The worker threads do host work only (PIL decode / resize / paste and numpy
stacking, which release the GIL). Every CUDA call, the pinning of host
memory included, happens on the thread that consumes the batches: a fresh
thread's first CUDA call would bind a context of its own. Example
randomness is keyed by ``(seed, epoch, index)`` (``datasets.fetch``), so
the batch stream is byte-identical for any ``num_workers``.
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from pcdms_tpu_torch.data.datasets import index_batches, stack_examples

# batches in flight ahead of the consumer in the worker pool
_PREFETCH_BATCHES = 2


def resolve_num_workers(n: int) -> int:
    """-1 -> auto: min(8, cpu_count), and 0 on a one-core host, where extra
    threads only add switching; the reference hardcodes 8."""
    if n >= 0:
        return n
    cpus = os.cpu_count() or 1
    return 0 if cpus == 1 else min(8, cpus)


class DataLoader:
    """Iterable of stacked numpy batches, fetched by ``num_workers``
    background threads (inline at 0, through the same ``dataset.fetch``).
    At most ``_PREFETCH_BATCHES`` batches are in flight ahead of the
    consumer."""

    def __init__(self, dataset, batch_size: int, *, num_workers: int = 0,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 epochs: Optional[int] = None):
        n = len(dataset)
        if n == 0 or (drop_last and n < batch_size):
            raise ValueError(
                f"dataset has {n} examples (batch_size {batch_size}, "
                f"drop_last={drop_last}): no batch can ever be formed "
                "(with epochs=None this would spin forever)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = resolve_num_workers(num_workers)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epochs = epochs

    def _plan(self):
        return index_batches(len(self.dataset), self.batch_size,
                              shuffle=self.shuffle, seed=self.seed,
                              drop_last=self.drop_last, epochs=self.epochs)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers <= 0:
            for epoch, idxs in self._plan():
                yield stack_examples([self.dataset.fetch(int(i), epoch)
                                      for i in idxs])
            return
        yield from self._iter_workers()

    def _iter_workers(self):
        plan = self._plan()
        window: collections.deque = collections.deque()
        with ThreadPoolExecutor(max_workers=self.num_workers,
                                thread_name_prefix="pcdms-data") as pool:

            def submit_next() -> bool:
                try:
                    epoch, idxs = next(plan)
                except StopIteration:
                    return False
                window.append([pool.submit(self.dataset.fetch, int(i), epoch)
                               for i in idxs])
                return True

            for _ in range(_PREFETCH_BATCHES):
                if not submit_next():
                    break
            while window:
                futures = window.popleft()
                submit_next()
                # .result() re-raises a worker's exception here, on the
                # consumer's thread: a failing decode stops the train loop
                yield stack_examples([f.result() for f in futures])


def _to_device(batch, device):
    """Each array of ``batch`` as a tensor on ``device``; host tensors bound
    for the card go through pinned memory and a non-blocking copy."""
    out = {}
    for k, x in batch.items():
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda" and x.device.type == "cpu":
            x = x.pin_memory()
        out[k] = x.to(device, non_blocking=True)
    return out


def prefetch_to_device(batches, device, depth: int = 2):
    """Yield each host batch of ``batches`` on ``device``, with the copies
    of the next ``depth`` batches enqueued before it is handed out, so they
    overlap the step on this one. The copies are made on the calling
    thread."""
    device = torch.device(device)
    window: collections.deque = collections.deque()
    it = iter(batches)
    exhausted = False
    while True:
        # fill to depth + 1: after the yield the consumer holds one batch
        # and ``depth`` copied batches sit ahead of it
        while not exhausted and len(window) <= depth:
            try:
                window.append(_to_device(next(it), device))
            except StopIteration:
                exhausted = True
        if not window:
            return
        yield window.popleft()
