"""Frozen-encoder bundles and trained-parameter export (counterpart of
``pcdms_tpu/train/frozen.py``), in the port's own format.

A bundle is one ``torch.save`` file, ``<dir>/frozen.pt``, mapping an encoder
name ("vae", "dino", "clip") to its module's state dict;
``load_frozen_modules`` builds the modules back from it. ``--frozen_dir`` makes every
trainer and sampler of a run use the same frozen encoders, which matters
for random-init and tiny-config runs where each would otherwise draw its
own. ``load_trained_params`` pulls the inference parameters (the EMA shadow
if the run tracked one, the raw parameters otherwise) out of a training
run's checkpoint directory, so a trained checkpoint drives
``stage2_generate``.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from pcdms_tpu_torch.train import checkpoint as ckpt
from pcdms_tpu_torch.train.common import by_model

logger = logging.getLogger("pcdms_tpu_torch.train.frozen")

_BUNDLE = "frozen.pt"


def save_frozen(directory, frozen: Dict[str, torch.nn.Module]) -> None:
    """Persist {name: module} (None values dropped) as one bundle. No-op if
    the bundle exists: the first writer wins, so every CLI pointed at one
    ``--frozen_dir`` shares one set of encoders."""
    frozen = {k: v for k, v in frozen.items() if v is not None}
    if not frozen:
        raise ValueError("nothing to save: all frozen entries are None")
    path = Path(directory) / _BUNDLE
    if path.exists():
        logger.info("frozen bundle already exists at %s; keeping it", path)
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save({k: m.state_dict() for k, m in frozen.items()}, tmp)
    os.replace(tmp, path)
    logger.info("frozen bundle saved to %s (%s)", path, sorted(frozen))


def load_frozen(directory) -> Dict[str, Dict[str, torch.Tensor]]:
    """{name: state dict} of a bundle saved by :func:`save_frozen`."""
    path = Path(directory) / _BUNDLE
    if not path.exists():
        raise FileNotFoundError(f"no frozen bundle at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_frozen_modules(directory,
                        builders: Dict[str, Callable[[], torch.nn.Module]]
                        ) -> Dict[str, torch.nn.Module]:
    """Build each encoder named in ``builders`` and load its weights from
    the bundle at ``directory``; raises ``KeyError`` if the bundle lacks
    one (the inference CLIs' ``--frozen_dir`` contract)."""
    bundle = load_frozen(directory)
    missing = sorted(set(builders) - set(bundle))
    if missing:
        raise KeyError(f"the frozen bundle in {directory} lacks {missing}")
    out = {}
    for name, build in builders.items():
        out[name] = build()
        out[name].load_state_dict(bundle[name])
    return out


def frozen_dir_or_build(directory: Optional[str],
                        builders: Dict[str, Callable[[], torch.nn.Module]]
                        ) -> Dict[str, torch.nn.Module]:
    """The train-CLI contract for ``--frozen_dir``: build each encoder, and
    load its weights from the bundle at ``directory`` where it has them. If
    there was no bundle, the built encoders are saved there. A bundle that
    lacks a key is not extended (it is immutable once written).
    ``directory=None`` builds without persisting."""
    existing = {}
    if directory and (Path(directory) / _BUNDLE).exists():
        existing = load_frozen(directory)
    out, built = {}, []
    for name, build in builders.items():
        out[name] = build()
        if name in existing:
            out[name].load_state_dict(existing[name])
        else:
            built.append(name)
    if built and directory:
        if existing:
            logger.warning("frozen bundle in %s lacks %s; built fresh (not "
                           "saved: the bundle is immutable once written)",
                           directory, built)
        else:
            save_frozen(directory, out)
    return out


def load_trained_params(ckpt_dir, step: Optional[int] = None,
                        prefer_ema: bool = True
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{model: state dict} for inference from a training run's checkpoint
    directory (latest step unless given): the EMA shadow when the run
    tracked one and ``prefer_ema``, else the raw parameters."""
    payload, step = ckpt.load_payload(ckpt_dir, step)
    if prefer_ema and payload.get("ema") is not None:
        logger.info("loaded EMA params from %s step %d", ckpt_dir, step)
        return by_model(payload["ema"])
    logger.info("loaded params from %s step %d", ckpt_dir, step)
    return payload["models"]
