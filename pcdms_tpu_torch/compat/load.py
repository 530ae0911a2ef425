"""Checkpoint loading (counterpart of ``pcdms_tpu/compat/load.py`` and of
the key handling of ``pcdms_tpu/compat/torch_convert.py``): local torch /
safetensors files -> state dicts of the port's modules.

The formats are the reference ecosystem's:
  * HF diffusers model directories (``diffusion_pytorch_model.bin`` or
    ``.safetensors`` under ``unet/`` / ``vae/`` subfolders);
  * transformers encoder directories (``pytorch_model.bin`` /
    ``model.safetensors``): CLIP ViT-H and DINOv2-giant;
  * the monolithic PCDMs training checkpoints (``mp_rank_00_model_states.pt``
    with a DeepSpeed ``module`` dict, or the demo's ``pcdms_ckpt.pt``), whose
    keys are prefixed ``unet.`` / ``pose_proj.`` / ``image_proj_model_p.``.

The port's modules carry the diffusers / HF names, so a file's keys are
the module's own. The loaders here do only what differs from the identity:
they unwrap the file, split a monolithic checkpoint by prefix, rename the
VAE's old mid-attention names (``query / key / value / proj_attn``) and
resize DINOv2's position embeddings to the target grid, as the JAX
converters do. :func:`load_into` then fits the result to the module's own
keys: a key the module has and the file lacks raises ``KeyError``, as the
JAX converters do for a key they read; keys the module lacks (HF buffers
such as ``position_ids`` or DINOv2's ``mask_token``, anything else in the
file) are logged and dropped. Every tensor comes back as f32 on the CPU.

``torch.load`` runs with ``weights_only=False``, as in the JAX package,
because DeepSpeed files hold non-tensor objects: it unpickles, so give it
trusted local paths only. Nothing is downloaded.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, Optional

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

logger = logging.getLogger("pcdms_tpu_torch.compat.load")

_WEIGHT_FILES = (
    "diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin",
    "model.safetensors", "pytorch_model.bin",
)
_CHECKPOINT_PREFIXES = ("unet.", "pose_proj.", "image_proj_model_p.",
                        "image_proj_model_g.", "image_proj_model.")
# the VAE's mid-block attention under its old diffusers names
_OLD_VAE_ATTENTION = re.compile(
    r"^((?:en|de)coder\.mid_block\.attentions\.0)\."
    r"(query|key|value|proj_attn)\.")
_NEW_VAE_ATTENTION = {"query": "to_q", "key": "to_k", "value": "to_v",
                      "proj_attn": "to_out.0"}


def load_state_dict(path: str) -> StateDict:
    """One torch / safetensors weight file -> {name: f32 CPU tensor}; a
    DeepSpeed ``module`` or a ``state_dict`` wrapper is unwrapped."""
    if path.endswith(".safetensors"):
        from pcdms_tpu_torch.compat.safetensors import load_file
        return {k: v.float() for k, v in load_file(path).items()}
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "module" in obj:     # DeepSpeed-style
        obj = obj["module"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    out, skipped = {}, []
    for k, v in obj.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().float()
        elif isinstance(v, np.ndarray):
            out[k] = torch.from_numpy(np.asarray(v, np.float32))
        else:
            skipped.append(k)
    if skipped:
        logger.info("%s: %d entries are not arrays, dropped: %s", path,
                    len(skipped), skipped[:5])
    return out


def load_model_dir(path: str, subfolder: Optional[str] = None) -> StateDict:
    """Find and load the weight file of an HF-style model directory (or
    ``path/subfolder`` itself when it is a file)."""
    directory = os.path.join(path, subfolder) if subfolder else path
    if os.path.isfile(directory):
        return load_state_dict(directory)
    for name in _WEIGHT_FILES:
        candidate = os.path.join(directory, name)
        if os.path.isfile(candidate):
            return load_state_dict(candidate)
    raise FileNotFoundError(f"no weight file found under {directory}")


def fit(sd: StateDict, keys, what: str) -> StateDict:
    """``sd`` cut to ``keys`` (a module's ``state_dict()`` keys): a missing
    key raises ``KeyError``; the keys not in ``keys`` are logged and
    dropped."""
    keys = list(keys)
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"{what}: {len(missing)} keys missing from the file: "
                       f"{missing[:5]}")
    extra = sorted(set(sd) - set(keys))
    if extra:
        logger.info("%s: %d keys not read, dropped: %s%s", what, len(extra),
                    extra[:5], " ..." if len(extra) > 5 else "")
    return {k: sd[k] for k in keys}


def load_into(module: torch.nn.Module, sd: StateDict, what: str):
    """Load ``sd`` (from a loader here) into ``module``: :func:`fit` to its
    keys, then a strict ``load_state_dict``, which checks the shapes.
    Returns the module."""
    module.load_state_dict(fit(sd, module.state_dict().keys(), what))
    return module


def rename_old_vae_attention(sd: StateDict) -> StateDict:
    """SD-2.1 ``AutoencoderKL`` keys under either mid-attention naming ->
    the port's VAE names (``to_q / to_k / to_v / to_out.0``)."""
    def new(m):
        return f"{m.group(1)}.{_NEW_VAE_ATTENTION[m.group(2)]}."
    return {_OLD_VAE_ATTENTION.sub(new, k): v for k, v in sd.items()}


def resize_dinov2_positions(sd: StateDict, target_grid=None) -> StateDict:
    """transformers ``Dinov2Model`` keys with the position embeddings resized
    to the ``target_grid`` (gh, gw) patch grid
    (``models/vit.py::interpolate_pos_embed``, the JAX package's bicubic),
    e.g. (16, 16) for 224 px; ``None`` keeps them."""
    from pcdms_tpu_torch.models.vit import interpolate_pos_embed

    key = "embeddings.position_embeddings"
    if target_grid is None or key not in sd:
        return sd
    return {**sd, key: interpolate_pos_embed(sd[key], *target_grid)}


def split_reference_checkpoint(sd: StateDict) -> Dict[str, StateDict]:
    """Split a reference stage-2 / 3 training checkpoint (keys prefixed
    ``unet.`` / ``pose_proj.`` / ``image_proj_model_p.`` /
    ``image_proj_model_g.`` / ``image_proj_model.``, after an optional
    ``module.``) into per-module state dicts; other keys are dropped."""
    groups: Dict[str, StateDict] = {}
    dropped = 0
    for key, value in sd.items():
        key = key.removeprefix("module.")
        for prefix in _CHECKPOINT_PREFIXES:
            if key.startswith(prefix):
                groups.setdefault(prefix[:-1], {})[key[len(prefix):]] = value
                break
        else:
            dropped += 1
    if dropped:
        logger.info("checkpoint split: %d keys under no module prefix, "
                    "dropped", dropped)
    return groups


# convenience wrappers --------------------------------------------------------

def load_sd_vae(pretrained_dir: str) -> StateDict:
    return rename_old_vae_attention(load_model_dir(pretrained_dir, "vae"))


def load_sd_unet(pretrained_dir: str, subfolder: str = "unet") -> StateDict:
    return load_model_dir(pretrained_dir, subfolder)


def load_prior(path: str) -> StateDict:
    return load_model_dir(path)


def load_clip_vision(path: str) -> StateDict:
    return load_model_dir(path)


def load_dinov2(path: str, target_grid=(16, 16)) -> StateDict:
    return resize_dinov2_positions(load_model_dir(path), target_grid)


def _load_pcdms_checkpoint(path: str, modules) -> Dict[str, StateDict]:
    groups = split_reference_checkpoint(load_state_dict(path))
    out = {name: groups[name] for name in ("unet",) + modules
           if name in groups}
    for key in ("image_proj_model_p", "image_proj_model"):
        if key in groups:
            out["image_proj"] = groups[key]
            break
    return out


def load_pcdms_stage2_checkpoint(path: str) -> Dict[str, StateDict]:
    """A monolithic stage-2 training checkpoint -> {"unet", "pose_proj",
    "image_proj"} state dicts (each where the file has it)."""
    return _load_pcdms_checkpoint(path, ("pose_proj",))


def load_pcdms_stage3_checkpoint(path: str) -> Dict[str, StateDict]:
    """A monolithic stage-3 training checkpoint -> {"unet", "image_proj"}
    state dicts (each where the file has it)."""
    return _load_pcdms_checkpoint(path, ())
