"""Host-side image preprocessing (numpy / PIL; NHWC outputs): the port's
own copy of ``pcdms_tpu/data/preprocess.py``.

Replicates the reference data layer's transforms
(``src/dataset/stage2_dataset.py:76-121`` of the reference):
  * bicubic resize to the working size;
  * ToTensor + Normalize(0.5, 0.5) -> [-1, 1];
  * CLIPImageProcessor defaults for the frozen encoders: shortest edge to
    224 (bicubic, long edge truncated), center-crop 224, scale 1/255,
    normalise by the CLIP mean / std (DINOv2 is fed the same way);
  * side-by-side canvases ([source | target], [source | black]).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from PIL import Image

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def load_image(path: str, size: Optional[Tuple[int, int]] = None):
    """Load an RGB image; size=(width, height) bicubic resize. Returns PIL."""
    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize(size, Image.BICUBIC)
    return img


def to_neg1_1(img) -> np.ndarray:
    """PIL / uint8 array -> (H, W, 3) float32 in [-1, 1]."""
    arr = np.asarray(img, np.float32) / 255.0
    return arr * 2.0 - 1.0


def clip_preprocess(img, size: int = 224) -> np.ndarray:
    """CLIPImageProcessor-equivalent -> (size, size, 3) float32."""
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img.astype(np.uint8))
    w, h = img.size
    # HF get_resize_output_image_size: shortest edge = size, the long edge
    # truncated by int()
    if w <= h:
        new_w, new_h = size, int(size * h / w)
    else:
        new_w, new_h = int(size * w / h), size
    img = img.resize((new_w, new_h), Image.BICUBIC)
    left = (new_w - size) // 2
    top = (new_h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD


def make_side_by_side(left, right) -> Image.Image:
    """Paste two same-size PIL images side by side."""
    w, h = left.size
    canvas = Image.new("RGB", (2 * w, h))
    canvas.paste(left, (0, 0))
    canvas.paste(right, (w, 0))
    return canvas


def black_like(img) -> Image.Image:
    return Image.new("RGB", img.size, (0, 0, 0))
