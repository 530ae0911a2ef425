"""Dynamic-batching inference engine (counterpart of
``pcdms_tpu/serve/engine.py``): an online request path that turns an
arbitrary arrival stream into fixed-size device batches.

The same design as the JAX engine, with the same behaviour and counters:

* **Bucketed batch sizes.** Every model call uses a batch size from a small
  fixed set (``buckets``); short batches are padded by repeating the last
  request. :meth:`InferenceEngine.warmup` runs each bucket once at startup
  (the kernels' build at first use, cuDNN's algorithm choice, the caching
  allocator's pools).
* **One dispatch thread, pipelined completion.** All device work funnels
  through one dispatch thread. CUDA launches are asynchronous: the
  dispatch thread queues each output's copy to pinned host memory behind
  the batch's kernels, records a CUDA event after it, and hands both to a
  completion thread, which waits on that event (never reading early)
  and resolves the futures while the dispatch thread already collects and
  launches the next batch. ``max_inflight`` (default 2 = double
  buffering) bounds how many dispatched batches may hold device memory.
* **Windowed batching, not continuous batching.** A diffusion request is a
  fixed-length program; requests are grouped into windows of at most
  ``max_delay_ms``.
* **Failure isolation.** An exception inside one model call fails only
  that batch's futures; the engine keeps serving.

Grad mode is per thread in PyTorch: the dispatch thread enters
``torch.inference_mode()`` itself (a ``no_grad`` in the caller does not
reach it), and so does :meth:`InferenceEngine.warmup`.

The engine is model-agnostic: requests are dicts of per-request numpy
arrays, ``batch_fn`` receives the same dict with a leading batch
dimension stacked on every leaf and returns a tensor, an array, or a
dict / list / tuple of them, each with that leading dimension. Results
come back as numpy, one row per request.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger("pcdms_tpu_torch.serve")


class EngineClosed(RuntimeError):
    """Raised by submit() after close(), and set on futures that were
    still queued when a non-draining close tore the engine down."""


@dataclasses.dataclass
class EngineStats:
    """Cumulative serving counters (see :meth:`InferenceEngine.stats`)."""
    requests: int = 0
    completed: int = 0
    failed: int = 0
    cancelled: int = 0
    batches: int = 0
    padded_slots: int = 0
    total_latency_s: float = 0.0     # submit -> result, summed per request
    max_latency_s: float = 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mean_latency_s"] = (self.total_latency_s / self.completed
                               if self.completed else 0.0)
        slots = self.completed + self.failed + self.padded_slots
        d["batch_occupancy"] = ((self.completed + self.failed) / slots
                                if slots else 0.0)
        return d


@dataclasses.dataclass
class _Pending:
    inputs: Dict[str, np.ndarray]
    future: Future
    t_submit: float


def _fail_future(fut: Future, exc: Exception):
    """set_exception tolerant of a racing client-side cancel()."""
    if fut.set_running_or_notify_cancel():
        fut.set_exception(exc)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _queue_to_host(out):
    """Queue every output tensor's copy to host memory behind the work
    that makes it; -> (tree of host tensors / other leaves, CUDA event or
    None). Pinned, non-blocking copies on the current stream: the event,
    recorded after them, marks when all of them have landed."""
    on_cuda = []

    def copy(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        leaf = leaf.detach()
        if not leaf.is_cuda:
            return leaf
        host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
        host.copy_(leaf, non_blocking=True)
        on_cuda.append(leaf)
        return host

    host = _tree_map(copy, out)
    if not on_cuda:
        return host, None
    event = torch.cuda.Event()
    event.record()
    return host, event


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.numpy()
    return np.asarray(leaf)


class DynamicBatcher:
    """Bounded request queue + batch-window collection.

    ``collect()`` blocks for the first request, then keeps gathering
    until ``max_batch`` requests are held or ``max_delay_s`` has elapsed
    since the first one was dequeued.
    """

    def __init__(self, max_batch: int, max_delay_s: float,
                 queue_size: int = 256):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self._q: "queue.Queue[_Pending]" = queue.Queue(queue_size)
        self._sealed = False
        self._seal_lock = threading.Lock()

    def put(self, item: _Pending, timeout: Optional[float] = None):
        """Enqueue with backpressure. Raises EngineClosed once the
        batcher is sealed: the seal-lock makes put-vs-seal atomic, so a
        request either lands before the final drain (and is served) or
        fails loudly; it is never silently stranded."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._seal_lock:
                if self._sealed:
                    raise EngineClosed("batcher sealed")
                try:
                    self._q.put_nowait(item)
                    return
                except queue.Full:
                    pass
            if deadline is not None and time.monotonic() >= deadline:
                raise queue.Full
            time.sleep(0.005)

    def seal_and_drain(self) -> List[_Pending]:
        """Atomically stop accepting new requests and take everything
        queued (see put)."""
        with self._seal_lock:
            self._sealed = True
            return self.drain()

    def pending(self) -> int:
        return self._q.qsize()

    def collect(self, poll_s: float = 0.05) -> List[_Pending]:
        """Gather one batch window; [] if nothing arrived within poll_s."""
        try:
            first = self._q.get(timeout=poll_s)
        except queue.Empty:
            return []
        out = [first]
        deadline = time.monotonic() + self.max_delay_s
        while len(out) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # take whatever is already queued, but stop waiting
                try:
                    out.append(self._q.get_nowait())
                    continue
                except queue.Empty:
                    break
            try:
                out.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return out

    def drain(self) -> List[_Pending]:
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out


class InferenceEngine:
    """Threaded dynamic-batching front end around a batched model call.

    batch_fn(batch: dict[str, np.ndarray]) -> a tensor / array, or a dict,
    list or tuple of them, every leaf with the batch size as leading
    dimension. Results are copied to the host once per batch and sliced
    per request.
    """

    def __init__(self, batch_fn: Callable[[Dict[str, np.ndarray]], object],
                 buckets: Sequence[int] = (1, 2, 4, 8),
                 max_delay_ms: float = 5.0,
                 queue_size: int = 256,
                 max_inflight: int = 2,
                 name: str = "engine"):
        if not buckets:
            raise ValueError("need at least one batch bucket")
        self._batch_fn = batch_fn
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if self.buckets[0] < 1:
            raise ValueError(f"buckets must be >= 1, got {self.buckets}")
        self.name = name
        self._batcher = DynamicBatcher(self.buckets[-1],
                                       max_delay_ms / 1000.0, queue_size)
        self._stats = EngineStats()
        self._lock = threading.Lock()
        self._closing = False
        self._drain_on_close = True
        # dispatched-but-unresolved batches; bounds device memory held by
        # results
        self._inflight: "queue.Queue" = queue.Queue(max(1, max_inflight))
        self._completer = threading.Thread(
            target=self._completion_loop, daemon=True,
            name=f"pcdms-serve-{name}-complete")
        self._completer.start()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"pcdms-serve-{name}")
        self._thread.start()

    # ---- client side ----

    def submit(self, inputs: Dict[str, np.ndarray],
               timeout: Optional[float] = None) -> Future:
        """Enqueue one request; blocks (backpressure) when the queue is
        full. Returns a Future resolving to this request's output slice."""
        if self._closing:
            raise EngineClosed(f"{self.name} is closed")
        fut: Future = Future()
        # put is atomic against the dispatch thread's seal_and_drain: it
        # either lands before the final drain (and is served / failed per
        # the drain contract) or raises EngineClosed here
        self._batcher.put(_Pending(dict(inputs), fut, time.monotonic()),
                          timeout=timeout)
        with self._lock:
            self._stats.requests += 1
        return fut

    def stats(self) -> dict:
        with self._lock:
            d = self._stats.as_dict()
        d["pending"] = self._batcher.pending()
        return d

    def warmup(self, example_inputs: Dict[str, np.ndarray]):
        """Run one batch per bucket (repeating ``example_inputs``) and wait
        for it, so that every bucket has run once before traffic arrives."""
        for b in self.buckets:
            batch = {k: np.stack([np.asarray(v)] * b)
                     for k, v in example_inputs.items()}
            with torch.inference_mode():
                _, event = _queue_to_host(self._batch_fn(batch))
            if event is not None:
                event.synchronize()
            logger.info("%s: warmed bucket %d", self.name, b)

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop accepting requests. drain=True (default) serves what is
        already queued first; drain=False fails queued requests with
        EngineClosed. Blocks until every dispatched batch has resolved."""
        self._drain_on_close = drain
        self._closing = True
        self._thread.join(timeout)
        self._completer.join(timeout)
        if self._thread.is_alive():
            # join timed out with the dispatch thread still draining;
            # don't steal its queue: it is serving the sealed backlog and
            # honours the drain contract when it finishes
            logger.warning("%s: close(timeout=%s) returned before the "
                           "drain finished", self.name, timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- dispatch side ----

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _loop(self):
        with torch.inference_mode():
            while True:
                if self._closing:
                    self._final_drain()
                    self._inflight.put(None)   # sentinel: completer exits
                    return
                batch = self._batcher.collect()
                if batch:
                    self._dispatch(batch)

    def _final_drain(self):
        # seal_and_drain is atomic against put(): everything a submit
        # managed to enqueue is in `drained`; later puts raise EngineClosed
        # at the submitter
        drained = self._batcher.seal_and_drain()
        if self._drain_on_close:
            pending = drained
        else:
            pending = []
            for p in drained:
                _fail_future(p.future, EngineClosed(f"{self.name} closed"))
            if drained:
                with self._lock:
                    self._stats.failed += len(drained)
        while pending:
            chunk, pending = (pending[:self.buckets[-1]],
                              pending[self.buckets[-1]:])
            self._dispatch(chunk)

    def _dispatch(self, pending: List[_Pending]):
        """Stack, pad, and launch one batch; its output's copy to the host
        is queued behind it and goes to the completion thread, so this
        thread can immediately collect and launch the next batch."""
        # claim the futures: marks them running so a client cancel() can
        # no longer land between here and set_result; drops
        # already-cancelled ones
        claimed = [p for p in pending
                   if p.future.set_running_or_notify_cancel()]
        if len(claimed) != len(pending):
            with self._lock:
                self._stats.cancelled += len(pending) - len(claimed)
        pending = claimed
        if not pending:
            return
        n = len(pending)
        bucket = self._bucket_for(n)
        keys = pending[0].inputs.keys()
        try:
            batch = {
                k: np.stack([np.asarray(p.inputs[k]) for p in pending]
                            + [np.asarray(pending[-1].inputs[k])]
                            * (bucket - n))
                for k in keys
            }
            out = _queue_to_host(self._batch_fn(batch))
        except Exception as e:  # noqa: BLE001 -- isolate to this batch
            self._fail_batch(pending, bucket, e)
            return
        # blocks when max_inflight batches are already dispatched:
        # backpressure on device memory held by unresolved results
        self._inflight.put((pending, out, bucket))

    def _completion_loop(self):
        while True:
            item = self._inflight.get()
            if item is None:
                return
            pending, (out, event), bucket = item
            try:
                if event is not None:
                    event.synchronize()
                host = _tree_map(_as_numpy, out)
            except Exception as e:  # noqa: BLE001 -- isolate to this batch
                self._fail_batch(pending, bucket, e)
                continue
            n = len(pending)
            now = time.monotonic()
            # resolve futures outside the lock: done-callbacks run inline
            # in this thread and may themselves call stats()
            lats = []
            for i, p in enumerate(pending):
                p.future.set_result(_tree_map(lambda a, i=i: a[i], host))
                lats.append(now - p.t_submit)
            with self._lock:
                self._stats.batches += 1
                self._stats.padded_slots += bucket - n
                self._stats.completed += n
                self._stats.total_latency_s += sum(lats)
                self._stats.max_latency_s = max(
                    [self._stats.max_latency_s] + lats)

    def _fail_batch(self, pending: List[_Pending], bucket: int,
                    exc: Exception):
        logger.exception("%s: batch of %d failed", self.name, len(pending))
        for p in pending:
            p.future.set_exception(exc)
        with self._lock:
            self._stats.failed += len(pending)
            self._stats.batches += 1
            self._stats.padded_slots += bucket - len(pending)
