"""The training loop (counterpart of ``pcdms_tpu/train/loop.py``).

One process drives one device; over a ``parallel/mesh.py::Mesh`` each rank
runs this loop on its own rows of the global batch. Logging, checkpoint
cadence, resume and the SIGTERM / SIGINT stop follow the JAX package's
loop. Host batches (dicts of numpy arrays or tensors) reach the device
through ``data/loader.py::prefetch_to_device``: pinned memory, non-blocking
copies, two batches ahead of the step. Each step draws its randomness from
a generator seeded with (seed, step), so a resumed run
draws what an uninterrupted one would; the loss functions draw for the
global batch and keep their rows, so a run does not depend on the world
size. ``--report_to tensorboard`` logs the loss and the example rate
through ``make_tensorboard_writer``; over a mesh, rank 0 logs, the example
rate counts the world's examples, a signal on any rank stops every rank at
the same step, and the checkpoint is written by rank 0 after ZeRO-1's
shards are gathered.
"""

from __future__ import annotations

import itertools
import logging
import signal
from typing import Callable, Iterator, Optional

import torch

from pcdms_tpu_torch.data.loader import prefetch_to_device
from pcdms_tpu_torch.parallel.mesh import Mesh, any_rank
from pcdms_tpu_torch.train import checkpoint as ckpt
from pcdms_tpu_torch.train.common import (
    TrainConfig, init_train_state, make_train_step,
)
from pcdms_tpu_torch.utils.profiling import (
    ThroughputMeter, start_trace, stop_trace,
)

logger = logging.getLogger("pcdms_tpu_torch.train")


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one train step: seeded with (seed, step)."""
    gen = torch.Generator(device=device)
    return gen.manual_seed((seed << 32) + step)


def run_training(loss_fn: Callable, models, batches: Iterator,
                 cfg: TrainConfig, *, device=None,
                 mesh: Optional[Mesh] = None, seed: int = 0,
                 output_dir: Optional[str] = None,
                 checkpointing_steps: int = 5000,
                 log_every: int = 50,
                 resume_from_checkpoint: bool = False,
                 max_train_steps: Optional[int] = None,
                 profile_dir: Optional[str] = None,
                 tensorboard_writer=None,
                 handle_preemption: bool = True,
                 on_step: Optional[Callable] = None):
    """Run the train loop on ``models`` (a dict of modules on ``device``,
    updated in place); returns the final ``TrainState``.

    ``loss_fn(models, batch, generator) -> (loss, metrics)``. ``batches``
    yields host batches; the next two are copied to the device ahead of
    the step. ``on_step(step, metrics)``, if given, is
    called after every step. ``tensorboard_writer`` (``add_scalar(tag,
    value, step)``) gets ``train_loss`` and ``examples_per_sec`` at every
    log step. With ``handle_preemption``, SIGTERM / SIGINT stop the
    loop at the next step boundary and write a final checkpoint.
    ``profile_dir`` gets a ``torch.profiler`` trace of steps 3-6. With a
    ``mesh``, ``batches`` yields this rank's rows and the models sit on
    ``mesh.device``.
    """
    if mesh is not None:
        device = mesh.device
    elif device is None:
        device = next(next(iter(models.values())).parameters()).device
    device = torch.device(device)
    main = mesh is None or mesh.is_main
    world = 1 if mesh is None else mesh.world
    max_steps = max_train_steps or cfg.max_train_steps

    # draw the first batch before the optimizer state is allocated: a batch
    # generator that builds a cache and frees its encoders on first next()
    # must not share the device with the AdamW moments
    batches = prefetch_to_device(batches, device)
    first_batch = next(batches, None)

    state = init_train_state(models, cfg, mesh)
    start_step = 0
    if resume_from_checkpoint and output_dir:
        if ckpt.latest_step(output_dir) is not None:
            state, _, start_step = ckpt.restore_checkpoint(output_dir, state)
            logger.info("resumed from %s at step %d", output_dir, start_step)

    step_fn = make_train_step(loss_fn, cfg, mesh)

    stop = {"signal": None}
    prev_handlers = {}
    if handle_preemption:
        def _on_signal(signum, frame):
            stop["signal"] = signum
            logger.warning("signal %d received: stopping at the next step "
                           "boundary and checkpointing", signum)

        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[s] = signal.signal(s, _on_signal)
            except ValueError:   # not the main thread; run unguarded
                break

    if first_batch is not None:
        batches = itertools.chain([first_batch], batches)
    meter = ThroughputMeter()
    step = start_step
    last_saved = start_step if start_step else None
    prof = None
    try:
        for batch in batches:
            # the checkpoint is collective: every rank stops at one step
            if step >= max_steps or any_rank(stop["signal"] is not None,
                                             mesh):
                break
            if profile_dir and main and step == start_step + 3:
                prof = start_trace(device.type == "cuda")
            if prof is not None and step == start_step + 6:
                prof = _stop_profile(prof, profile_dir)

            metrics = step_fn(state, batch, step_generator(seed, step,
                                                           device))
            step += 1
            meter.update(len(next(iter(batch.values()))) * world)
            if on_step is not None:
                on_step(step, metrics)

            if main and (step % log_every == 0 or step == start_step + 1):
                # reading the loss waits for the step: the window below
                # spans finished steps
                loss = float(metrics["loss"])
                ips = meter.rate()
                logger.info("step %d loss %.5f | %.2f examples/s", step,
                            loss, ips)
                if tensorboard_writer is not None:
                    tensorboard_writer.add_scalar("train_loss", loss, step)
                    tensorboard_writer.add_scalar("examples_per_sec", ips,
                                                  step)
                meter.reset()

            if output_dir and step % checkpointing_steps == 0:
                ckpt.save_checkpoint(output_dir, step, state, mesh=mesh)
                last_saved = step
                logger.info("checkpoint saved at step %d", step)
        if prof is not None:
            # a short run can end before step start + 6: flush the trace
            prof = _stop_profile(prof, profile_dir)
        if output_dir and step != last_saved:
            # the cadence may have saved this very step already; this save
            # also covers a stop by signal (handlers still installed)
            ckpt.save_checkpoint(output_dir, step, state, mesh=mesh)
            last_saved = step
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        if prof is not None:
            prof.stop()
        if tensorboard_writer is not None:
            tensorboard_writer.flush()
    if stop["signal"] is not None:
        logger.warning("stopped by signal %d at step %d (checkpoint %s)",
                       stop["signal"], step,
                       "saved" if output_dir else "not saved: no output_dir")
    return state


def _stop_profile(prof, profile_dir: str):
    path = stop_trace(prof, profile_dir)
    logger.info("profile of steps 3-6 written to %s", path)
    return None


def make_tensorboard_writer(logging_dir: str):
    """A ``torch.utils.tensorboard.SummaryWriter`` on ``logging_dir`` (the
    reference's ``--report_to tensorboard``), or None with a warning when
    tensorboard does not import: the metrics then go to the log only."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        logger.warning("tensorboard unavailable; metrics log to stdout only")
        return None
    return SummaryWriter(logging_dir)
