"""The trainer: the family's training step (state, optimizer and all) driven
from the seed through its first ``check_steps`` steps in set-up, on rows
that all differ, then handed, the same object, to the window, which runs
whole steps until ``--seconds`` have passed.

Traffic parameters: ``batch``, ``learning_rate``, ``lr_scheduler``,
``max_grad_norm``, ``noise_offset``, ``distinct_batches`` (the pool of
batches, made in set-up, every row from its own seed), ``check_steps``
and ``trace_steps``.

The check holds the first steps against the reference's: each step's
loss, each leaf's first gradient as the optimizer got it (its first moment
after one step over 1 - beta1), and each leaf's change after the checked
steps (read before the window trains on), each by the worst leaf: the gap
between the program's norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone under Adam and are left out of the change.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import trace as tr
from benchmark.weights import derive_seed

BETA1 = 0.9
TINY_GRAD = 1e-3


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers that ``correct`` holds to their limits."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    g_med = float(np.median(list(ref["grad"].values())))
    grad = max(abs(prog["grad"][k] - g) / max(g, g_med)
               for k, g in ref["grad"].items())
    keep = [k for k, g in ref["grad"].items() if g >= TINY_GRAD * g_med]
    d_med = float(np.median([ref["delta"][k] for k in keep]))
    delta = max(abs(prog["delta"][k] - ref["delta"][k])
                / max(ref["delta"][k], d_med) for k in keep)
    return {"loss_rel": loss, "grad_rel": grad, "delta_rel": delta}


class Driver:
    def __init__(self, run):
        self.run = run
        self.fam, self.p, self.cfg = run.family, run.params, run.config

    def _batch(self, k: int) -> dict:
        return self.pool[k % len(self.pool)]

    def _step(self, k: int):
        gen = self.step_gen(self.run.seed, k, self.run.device)
        return self.step_fn(self.state, self._batch(k), gen)

    def setup(self):
        run, fam, dev, p = self.run, self.fam, self.run.device, self.p
        self.models, self.state, self.step_fn, self.step_gen = (
            fam.make_trainer(self.cfg, run.seed, p, dev))
        self.pool = [fam.make_train_batch(
            self.cfg, [derive_seed(run.seed, k, i) for i in range(p["batch"])],
            dev) for k in range(p["distinct_batches"])]
        names = [n for n, _ in self.state.named]
        losses = []
        for k in range(p["check_steps"]):
            losses.append(float(self._step(k)["loss"]))
            if k == 0:
                # an optimizer that kept no first moment got no gradient
                moments = self.state.optimizer.state
                grad = {n: float(torch.linalg.vector_norm(
                    moments[q]["exp_avg"]) / (1 - BETA1))
                    if "exp_avg" in moments.get(q, {}) else 0.0
                    for n, q in self.state.named}
        start = fam.draw_weights(self.cfg, run.seed, dev, fam.TRAINED,
                                 fam.MASTER)
        now = dict(self.state.named)
        delta = {n: float(torch.linalg.vector_norm(
            now[n].detach() - start[n.split(".", 1)[0]][n.split(".", 1)[1]]))
            for n in names}
        del start
        self.prog = {"loss": losses, "grad": grad, "delta": delta}
        self.steps = p["check_steps"]
        _sync(dev)

    def window(self):
        run, dev, p = self.run, self.run.device, self.p
        prof = timers = None
        if run.trace and dev.type == "cuda":
            timers = tr.CallShapes(self.models["unet"])
            prof = tr.Profile()
            prof.start()
        done = []
        t0 = time.perf_counter()
        while True:
            self._step(self.steps)
            self.steps += 1
            _sync(dev)
            done.append(time.perf_counter() - t0)
            if run.trace and len(done) >= p["trace_steps"]:
                break
            if not run.trace and done[-1] >= run.seconds:
                break
        n = len(done) * p["batch"]
        run.attempted = n
        run.window_s = done[-1]
        run.e2e["train_examples_per_s"] = n / done[-1]
        run.notes["window_steps"] = len(done)
        run.notes["step_s"] = [round(b - a, 4) for a, b in
                               zip([0.0] + done[:-1], done)]
        run.window_work = len(done) * self.fam.train_work(self.cfg,
                                                          p["batch"])
        if prof is not None:
            run.attn_calls = timers.remove()
            run.summary = prof.stop(run.notes)

    def release(self):
        del self.state, self.step_fn, self.models

    def check(self) -> dict:
        run, fam, p = self.run, self.fam, self.p
        ref = fam.reference_train(
            self.cfg, run.seed, [self._batch(k)
                                 for k in range(p["check_steps"])],
            p, run.device)
        run.notes["losses"] = {"program": self.prog["loss"],
                               "reference": ref["loss"]}
        return compare(self.prog, ref)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
