"""PyTorch / CUDA port of ``pcdms_tpu`` for NVIDIA Hopper (H100).

The layout mirrors ``pcdms_tpu/``: each module here has a counterpart of
the same path there, which stays the numerical reference. Public functions
keep the JAX package's layouts (NHWC images and latents, ``(B, H, L, D)``
attention) so the two sides compare like with like; the one exception is
the fused conv (``ops/fused_conv.py``), which works on the UNet's NCHW
activations and torch weights inside the resnet blocks.

Entry points take ``device=None``, meaning CUDA; they raise when CUDA is
absent unless the caller asks for ``device="cpu"`` (which the tests do).
Every Pallas kernel of the JAX package is hand-written CUDA C++ for
``sm_90a`` here (``ops/csrc``: the flash-attention forward and backward
kernels and the fused GroupNorm + SiLU + conv3x3), built with ``nvcc`` at
first use.
"""

from pcdms_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
