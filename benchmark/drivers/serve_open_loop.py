"""Open-loop serving: single requests offered to the family's service at a
fixed rate, on a schedule made from the seed, whatever the service does.

Traffic parameters: ``rate`` (requests/s), the service's ``num_steps``,
``scheduler``, ``guidance_scale``, ``buckets``, ``max_delay_ms`` and
``queue_size``. After the window the first and the last request of one
of the fullest batches are compared with the reference. The traced run
profiles the whole window.

Every seed gets the same arrivals: the gaps are the quantiles of the
exponential law at ``rate`` in one fixed shuffled order (Poisson-like
bursts), and the seed draws the requests' contents and the weights. On an
H100 at 1.9 requests/s with buckets 1, 2, 4 and 8, a batch's size set its
length and so the next batch's size, and the 90th percentile swung by
14-24 % between runs of one order; with the one bucket of 8 every batch
lasts as long and reruns agree within a few percent.

A request is timed from when it was due, so a late generator or a stall
counts against it; the window is the requests due in ``--seconds``, and
each is waited for up to a minute past the window's close. A request that
fails or never comes counts as missing every latency.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import threading
import time

import numpy as np
import torch

from benchmark import trace as tr
from benchmark.drivers.sample import rel_l2
from benchmark.weights import derive_seed

GRACE_S = 60.0


ORDER_SEED = 11


def arrival_times(rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of ``round(rate * seconds)``
    requests: exponential-quantile gaps in one fixed shuffled order."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps *= seconds / gaps.sum()
    order = np.random.default_rng(ORDER_SEED).permutation(n)
    return np.cumsum(gaps[order]) - gaps[order][0]


def percentile(values, q: float) -> float:
    """Nearest-rank percentile over every value (inf for a missing one)."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def drive(submit, due: np.ndarray, batch_id=lambda: 0):
    """Offer request j at ``due[j]`` through ``submit(j) -> Future``.
    Returns (futures, completion times, start, lateness, batch of each
    request) with times from ``time.perf_counter``; ``batch_id()`` is read
    as each answer comes, in the thread that resolves it."""
    done, batch = {}, {}
    lock = threading.Lock()
    futs, late = [], []

    def mark(j):
        def cb(_):
            b = batch_id()
            with lock:
                done[j] = time.perf_counter()
                batch[j] = b
        return cb

    t0 = time.perf_counter()
    for j, d in enumerate(due):
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        now = time.perf_counter()
        late.append(now - (t0 + d))
        fut = submit(j)
        fut.add_done_callback(mark(j))
        futs.append(fut)
    cf.wait(futs, timeout=max(0.0, t0 + due[-1] + GRACE_S
                              - time.perf_counter()))
    with lock:
        return futs, dict(done), t0, late, dict(batch)


def latencies(futs, done: dict, t0: float, due: np.ndarray):
    """Seconds from due to answer per request (inf where none came or it
    failed), and the count that failed."""
    out, failed = [], 0
    for j, f in enumerate(futs):
        ok = f.done() and not f.cancelled() and f.exception() is None
        if ok and j in done:
            out.append(done[j] - (t0 + due[j]))
        else:
            out.append(math.inf)
            failed += 1
    return out, failed


def host_requests(fam, cfg: dict, seeds, device) -> dict:
    """The requests of ``seeds``, made on the device in chunks of 16 and
    kept on the host as numpy, as a client would send them."""
    host = {}
    for a in range(0, len(seeds), 16):
        for k, v in fam.make_rows(cfg, seeds[a:a + 16], device).items():
            host.setdefault(k, []).append(v.cpu().numpy())
    return {k: np.concatenate(v) for k, v in host.items()}


def check_picks(seed: int, batch_of: dict) -> list:
    """The first and the last request of one of the fullest batches, drawn
    from the seed (``batch_of``: request -> batch). The engine fills a
    batch's slots in arrival order, so these are its first slot and its
    last real one: a fault in the batch's first or second half shows."""
    batches = {}
    for j, b in sorted(batch_of.items()):
        batches.setdefault(b, []).append(j)
    if not batches:
        return []
    most = max(len(v) for v in batches.values())
    full = sorted(b for b, v in batches.items() if len(v) == most)
    rows = batches[full[int(np.random.default_rng([seed, 7])
                                .integers(len(full)))]]
    return sorted({rows[0], rows[-1]})


class Driver:
    def __init__(self, run):
        self.run = run
        self.fam, self.p, self.cfg = run.family, run.params, run.config

    def setup(self):
        run, fam, dev, p = self.run, self.fam, self.run.device, self.p
        self.models = fam.program_models(self.cfg, run.seed, dev)
        self.due = arrival_times(p["rate"], run.seconds)
        self.seeds = [derive_seed(run.seed, j) for j in range(len(self.due))]
        self.host = host_requests(fam, self.cfg, self.seeds, dev)
        self.service = fam.make_service(self.models, self.cfg, p, dev)
        self.service.engine.warmup(self.service._example())

    def window(self):
        run, p = self.run, self.p
        before = self.service.stats()
        prof = None
        if run.trace and run.device.type == "cuda":
            prof = tr.Profile()
            prof.start()
        # the engine counts a batch once all of its answers are set, so
        # every answer of one batch reads the same count
        futs, done, t0, late, self.batch_of = drive(
            lambda j: self.fam.submit(self.service, self.host, j,
                                      self.seeds[j]), self.due,
            lambda: self.service.stats()["batches"])
        if prof is not None:
            torch.cuda.synchronize(run.device)
            run.summary = prof.stop(run.notes)
        lat, failed = latencies(futs, done, t0, self.due)
        after = self.service.stats()
        self.futs = futs
        run.attempted, run.failed = len(futs), failed
        run.e2e["request_p90_s"] = percentile(lat, 90)
        run.window_s = max(done.values(), default=t0) - t0
        finite = sorted(x for x in lat if math.isfinite(x))
        run.notes["requests"] = len(futs)
        run.notes["beyond_p90"] = sum(x > run.e2e["request_p90_s"]
                                      for x in lat)
        run.notes["p50_s"] = percentile(lat, 50)
        run.notes["max_s"] = finite[-1] if finite else math.inf
        run.notes["lateness_max_s"] = max(late)
        d = {k: after[k] - before[k]
             for k in ("completed", "failed", "batches", "padded_slots")}
        slots = d["completed"] + d["failed"] + d["padded_slots"]
        run.engine = {"mean_batch": (d["completed"] / d["batches"]
                                     if d["batches"] else None),
                      "occupancy": ((d["completed"] + d["failed"]) / slots
                                    if slots else None)}
        run.notes["engine"] = d

    def release(self):
        self.service.close()
        del self.service, self.models

    def check(self) -> dict:
        """The widest relative L2 gap between an answered request's image
        and the reference's, over ``check_picks``."""
        run, fam, p = self.run, self.fam, self.p
        answered = {j: self.batch_of[j] for j, f in enumerate(self.futs)
                    if f.done() and f.exception() is None
                    and j in self.batch_of}
        picks = check_picks(run.seed, answered)
        nets = fam.reference_models(self.cfg, run.seed, run.device)
        worst = 0.0 if picks else math.inf
        for j in picks:
            rows = fam.make_rows(self.cfg, [self.seeds[j]], run.device)
            ref = fam.reference_row(nets, rows, 0, p)
            out = torch.from_numpy(np.asarray(self.futs[j].result()))
            worst = max(worst, rel_l2(out.to(ref.device), ref))
        run.notes["checked_requests"] = picks
        return {"image_rel_l2": worst}
