"""Training checkpoints with resume (counterpart of
``pcdms_tpu/train/checkpoint.py``), in the port's own format.

A checkpoint is one ``torch.save`` file, ``<dir>/step_<N>.pt``, holding the
trainable modules' state dicts, the optimizer state, the micro-step count,
the accumulated gradient and the EMA shadow (``TrainState.state_dict``)
plus the epoch. It is written to a temporary file and renamed, so a reader
sees a whole checkpoint or none; the newest ``max_to_keep`` are kept. The
port does not read the JAX package's orbax checkpoints.

Over a mesh, saving is collective: every rank gathers ZeRO-1's optimizer
shards (``TrainState.optimizer_state``), rank 0 writes, and all wait at a
barrier. The file holds the whole optimizer state as ``torch.optim.AdamW``
keeps it, so a run resumes from it at any world size, with ZeRO-1 or
without, as the JAX package's orbax restore reshards.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional

import torch

from pcdms_tpu_torch.parallel.mesh import barrier

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(directory) -> List[int]:
    d = Path(directory)
    if not d.is_dir():
        return []
    return sorted(int(m.group(1)) for p in d.iterdir()
                  if (m := _NAME.match(p.name)))


def checkpoint_path(directory, step: int) -> Path:
    return Path(directory) / f"step_{step}.pt"


def latest_step(directory) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def save_checkpoint(directory, step: int, state, epoch: int = 0,
                    max_to_keep: int = 5, mesh=None) -> Path:
    """Write ``state`` (a ``TrainState``) as the checkpoint of ``step``; over
    a ``mesh`` every rank calls this and rank 0 writes."""
    path = checkpoint_path(directory, step)
    payload = dict(state.state_dict(), epoch=epoch)
    if mesh is None or mesh.is_main:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in _steps(directory)[:-max_to_keep]:
            checkpoint_path(directory, old).unlink(missing_ok=True)
    barrier(mesh)
    return path


def load_payload(directory, step: Optional[int] = None,
                 map_location="cpu") -> tuple:
    """(payload dict, step) of the given or latest checkpoint."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    payload = torch.load(checkpoint_path(directory, step),
                         map_location=map_location, weights_only=True)
    return payload, step


def restore_checkpoint(directory, state, step: Optional[int] = None):
    """Load the given or latest checkpoint into ``state`` (a ``TrainState``
    built like the saved one), on the state's device. Returns (state,
    epoch, step)."""
    device = state.params[0].device if state.params else "cpu"
    payload, step = load_payload(directory, step, map_location=device)
    epoch = int(payload.pop("epoch"))
    state.load_state_dict(payload)
    return state, epoch, step
