"""Frozen-encoder passes (counterpart of ``pcdms_tpu/train/encoders.py``):
the DINOv2 features of a source image and the CLIP image embedding of a
target, computed in the compute dtype (bf16 by default) and returned in
f32, without gradients."""

from __future__ import annotations

import numpy as np
import torch

from pcdms_tpu_torch.utils.tree import cast_tree


def _encode(model, pixels, compute_dtype, key: str):
    dev = next(model.parameters()).device
    if isinstance(pixels, np.ndarray):
        pixels = torch.from_numpy(np.ascontiguousarray(pixels))
    with torch.inference_mode():
        m = cast_tree(model, compute_dtype)
        out = m(pixels.to(device=dev, dtype=compute_dtype))
    return out[key].float()


def clip_image_embed(model, pixels, compute_dtype=torch.bfloat16):
    """pixels: (B, 224, 224, 3) CLIP-preprocessed -> (B, proj_dim)."""
    return _encode(model, pixels, compute_dtype, "image_embeds")


def dino_features(model, pixels, compute_dtype=torch.bfloat16):
    """pixels: (B, 224, 224, 3) -> (B, 257, hidden) last_hidden_state."""
    return _encode(model, pixels, compute_dtype, "last_hidden_state")
