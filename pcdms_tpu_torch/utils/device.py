"""Device resolution: CUDA by default, the CPU only when asked for."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. A CUDA device raises when CUDA is absent, so
    no entry point drops to the CPU silently; pass ``"cpu"`` to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
