"""Closed-loop batch sampling: back-to-back batches of requests through the
family's ``generate`` (the batch-test sampler), one batch in flight.

Traffic parameters: ``batch``, ``num_steps``, ``scheduler``,
``guidance_scale``, ``distinct_batches`` (the pool of request batches
the window cycles through, made in set-up, every row from its own seed),
``check_rows`` (images compared with the reference after the window,
drawn from the seed: one from each of as many equal runs of a batch's
slots, each in a window batch of its own draw) and
``trace_batches`` (the batches the traced run profiles).

The window runs whole batches until ``--seconds`` have passed: it ends when
the batch that crosses that mark completes, so ``images_per_s`` is every
image of the window over all of its time.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import trace as tr
from benchmark.weights import derive_seed


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def check_picks(seed: int, batches: int, batch: int, rows: int) -> list:
    """``rows`` window images (index = batch * ``batch`` + slot), drawn from
    the seed: the slots are cut into ``rows`` equal runs and each pick takes
    one slot of its run, in a batch of its own draw, so two picks cover
    both halves of a batch and a fault in either half is seen."""
    rng = np.random.default_rng([seed, 7])
    rows = min(rows, batch)
    edges = [g * batch // rows for g in range(rows + 1)]
    return sorted(int(rng.integers(batches)) * batch
                  + int(rng.integers(edges[g], edges[g + 1]))
                  for g in range(rows))


class Driver:
    def __init__(self, run):
        self.run = run
        self.fam, self.p, self.cfg = run.family, run.params, run.config

    def _rows(self, k: int) -> list:
        return [derive_seed(self.run.seed, k, i)
                for i in range(self.p["batch"])]

    def setup(self):
        run, fam, dev = self.run, self.fam, self.run.device
        self.models = fam.program_models(self.cfg, run.seed, dev)
        self.pool = [fam.make_rows(self.cfg, self._rows(k), dev)
                     for k in range(self.p["distinct_batches"])]
        fam.generate(self.models, self.pool[0], self.p, dev)
        _sync(dev)

    def window(self):
        run, fam, dev, p = self.run, self.fam, self.run.device, self.p
        timers = prof = None
        if run.trace and dev.type == "cuda":
            timers = (tr.ModuleTimer(self.models["unet"]),
                      tr.CallShapes(self.models["unet"]))
            prof = tr.Profile()
            prof.start()
        self.outs, done = [], []
        t0 = time.perf_counter()
        while True:
            k = len(self.outs)
            self.outs.append(fam.generate(self.models,
                                          self.pool[k % len(self.pool)], p,
                                          dev))
            _sync(dev)
            done.append(time.perf_counter() - t0)
            if run.trace and len(self.outs) >= p["trace_batches"]:
                break
            if not run.trace and done[-1] >= run.seconds:
                break
        n = len(self.outs) * p["batch"]
        run.attempted = n
        run.window_s = done[-1]
        run.e2e["images_per_s"] = n / done[-1]
        run.notes["window_batches"] = len(self.outs)
        run.notes["batch_s"] = [round(b - a, 4) for a, b in
                                zip([0.0] + done[:-1], done)]
        run.window_work = fam.work(self.cfg, n, p)
        if prof is not None:
            run.unet_ms = timers[0].remove()
            run.attn_calls = timers[1].remove()
            run.summary = prof.stop(run.notes)

    def release(self):
        del self.models

    def check(self) -> dict:
        """The widest relative L2 gap between a window image and the
        reference's image of the same request, over ``check_picks``."""
        run, fam, p = self.run, self.fam, self.p
        picks = check_picks(run.seed, len(self.outs), p["batch"],
                            p["check_rows"])
        nets = fam.reference_models(self.cfg, run.seed, run.device)
        worst = 0.0
        for j in picks:
            k, i = divmod(j, p["batch"])
            ref = fam.reference_row(nets, self.pool[k % len(self.pool)], i, p)
            worst = max(worst, rel_l2(self.outs[k][i], ref))
        run.notes["checked_images"] = picks
        return {"image_rel_l2": worst}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
