"""Fused GroupNorm + SiLU + conv3x3 (+ time embedding | + residual): the
CUDA kernel, its plain version and the resnet-conv entry point.

Counterpart of ``pcdms_tpu/ops/fused_conv.py``. The Pallas TPU kernel
``_fused_kernel`` is hand-written CUDA C++ for Hopper here
(``csrc/fused_conv.cu``):

    y = conv3x3(silu(x * a + c)) + bias (+ temb[b] | + residual)

with the GroupNorm folded into per-(B, C) f32 coefficients ``a``, ``c`` by
``gn_affine_coeffs`` (torch ops in the wrapper, as JAX computes them in XLA
outside its kernel). Layouts are the port's: x, the residual and y are NCHW
and the weight is torch's (Cout, Cin, 3, 3); the kernel reads it re-laid to
(Cout, 3, 3, Cin), which ``relaid_weight`` keeps on the weight tensor and
makes again only when the weight changes (its storage or version).

In bf16 a block of the kernel owns an 8 x 16 tile of output pixels and 160
output channels, walks Cin in chunks of 64 and, where the grid would leave
SMs idle, splits the chunks over several blocks whose f32 partial sums a
second kernel adds (``conv_plan`` mirrors these choices).

The TPU fit rules (``fits_fused_conv``, ``_pick_co_block``,
``_pick_h_block``) have no counterpart: they exist because the TPU kernel
keeps a whole padded slab in VMEM, while the CUDA kernel streams x and the
weight through shared memory. Every shape in the kernel's domain (Cin a
multiple of 8) launches it; a CUDA tensor outside the domain raises.

There is no backward, as the JAX kernel has no VJP: ``fused_conv`` is an
inference option. On a CUDA tensor under autograd the wrapper raises; on
the CPU the plain version is differentiable, as JAX's XLA fallback is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pcdms_tpu_torch.ops import _build
from pcdms_tpu_torch.ops.flash_attention import LAUNCHES, _sm_count

_MODES = {"none": 0, "temb": 1, "residual": 2}

# the bf16 kernel's block (csrc/fused_conv.cu): an 8 x 16 tile of output
# pixels, 160 output channels, 64 input channels a chunk, a ring of six
# weight tiles; shared memory of one block on an H100
CONV_TILE_H, CONV_TILE_W, CONV_BLOCK_N, CONV_CHUNK = 8, 16, 160, 64
CONV_STAGES = 6
SMEM_LIMIT = 232448


def gn_affine_coeffs(x, scale, shift, num_groups: int, eps: float):
    """GroupNorm of NCHW ``x`` folded into f32 (B, C) coefficients ``a``,
    ``c`` with gn(x) = x * a + c (``gn_affine_coeffs``: mean, two-pass
    variance, rsqrt)."""
    b, ch = x.shape[:2]
    g = num_groups
    x32 = x.float().reshape(b, g, -1)
    mean = x32.mean(-1)                                          # (B, G)
    var = (x32 - mean[..., None]).square().mean(-1)
    rstd = torch.rsqrt(var + eps)
    a = rstd.repeat_interleave(ch // g, dim=1) * scale.float()[None]
    c = shift.float()[None] - mean.repeat_interleave(ch // g, dim=1) * a
    return a, c


def fused_gn_silu_conv_plain(x, a, c, weight, bias, temb=None, residual=None,
                             apply_act: bool = True):
    """The kernel's arithmetic in torch ops: the f32 affine (and SiLU),
    rounded to x's dtype, an f32 conv of the rounded values with the weight
    in x's dtype, then + bias, + temb or residual (each in x's dtype) in
    f32, and one rounding to x's dtype."""
    xn = x.float() * a[:, :, None, None] + c[:, :, None, None]
    if apply_act:
        xn = F.silu(xn)
    xn = xn.to(x.dtype).float()
    y = F.conv2d(xn, weight.to(x.dtype).float(), padding=1)
    y = y + bias.float()[None, :, None, None]
    if temb is not None:
        y = y + temb.to(x.dtype).float()[:, :, None, None]
    if residual is not None:
        y = y + residual.to(x.dtype).float()
    return y.to(x.dtype)


def _check(x, a, c, weight, bias, extra):
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the fused conv kernel takes bf16 or f32 x, got "
                        f"{x.dtype}")
    if cin % 8:
        raise ValueError(f"the fused conv kernel takes Cin a multiple of 8, "
                         f"got {cin}")
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"weight must be (Cout, {cin}, 3, 3), got "
                         f"{tuple(weight.shape)}")
    if tuple(bias.shape) != (cout,) or tuple(a.shape) != (b, cin) or tuple(
            c.shape) != (b, cin):
        raise ValueError("bias must be (Cout,) and a, c (B, Cin)")
    for t in (x, a, c, weight, bias) + ((extra,) if extra is not None
                                        else ()):
        if t.device != x.device:
            raise ValueError("all fused conv operands must lie on one device")


def relayout_weight(weight, dtype):
    """The torch (Cout, Cin, 3, 3) weight in ``dtype``, re-laid K-major to
    (Cout, 3, 3, Cin) for the kernel: one tap's channels of one output
    channel are contiguous."""
    return weight.to(dtype).permute(0, 2, 3, 1).contiguous()


def relaid_weight(weight, dtype):
    """``relayout_weight(weight, dtype)``, made once per version of the
    weight and kept on the tensor: the key is its storage, offset, shape,
    strides, version counter, dtype and device, so an in-place update
    (``copy_``, an optimizer step) or a new storage makes it again. A
    tensor made under ``torch.inference_mode`` has no version counter and
    is re-laid on every call."""
    if weight.is_inference():
        return relayout_weight(weight, dtype)
    key = (weight.untyped_storage().data_ptr(), weight.storage_offset(),
           tuple(weight.shape), weight.stride(), weight._version, dtype,
           weight.device)
    kept = getattr(weight, "_pcdms_relaid", None)
    if kept is not None and kept[0] == key:
        return kept[1]
    relaid = relayout_weight(weight, dtype)
    weight._pcdms_relaid = (key, relaid)
    return relaid


def conv_plan(b: int, cin: int, cout: int, h: int, w: int,
              sms: int = 132) -> dict:
    """How the bf16 kernel covers a (b, cin, h, w) -> cout conv on ``sms``
    SMs. Block (tile, n_block, image * split + z) owns output pixels rows
    [8 ty, + 8) x columns [16 tx, + 16) (tile = ty * tiles_w + tx) of its
    image, channels [160 n_block, + 160), and the input-channel chunks
    ``chunk_ranges[z]`` (64 channels each, all 9 taps of each). ``split`` >
    1 where the (tile, N block, image) blocks are fewer than half the SMs:
    the chunks are shared out so that about ``sms`` blocks run, and a
    second kernel adds their f32 partial sums. ``window_rows``: the haloed
    window of a tile that each chunk activates; ``smem``: the block's
    shared memory (windows, weight ring and barriers, 1024 bytes of
    alignment)."""
    tiles_h = -(-h // CONV_TILE_H)
    tiles_w = -(-w // CONV_TILE_W)
    n_blocks = -(-cout // CONV_BLOCK_N)
    chunks = -(-cin // CONV_CHUNK)
    blocks = tiles_h * tiles_w * n_blocks * b
    split = max(1, min(chunks, sms // blocks))
    window_rows = (CONV_TILE_H + 2) * (CONV_TILE_W + 2)
    smem = (2 * window_rows * CONV_CHUNK * 2
            + CONV_STAGES * CONV_BLOCK_N * CONV_CHUNK * 2
            + 2 * CONV_STAGES * 8 + 1024)
    return dict(tile=(CONV_TILE_H, CONV_TILE_W), tiles_h=tiles_h,
                tiles_w=tiles_w, block_n=CONV_BLOCK_N, n_blocks=n_blocks,
                chunk=CONV_CHUNK, chunks=chunks, split=split,
                chunk_ranges=[range(z * chunks // split,
                                    (z + 1) * chunks // split)
                              for z in range(split)],
                grid=(tiles_h * tiles_w, n_blocks, b * split),
                window_rows=window_rows, smem=smem)


def launch_fused_conv(x, a, c, weight_k, bias, extra, mode: int,
                      apply_act: bool):
    """Launch the kernel on checked, contiguous CUDA operands: x (B, Cin, H,
    W), a / c (B, Cin) f32, ``weight_k`` from ``relayout_weight``, bias
    (Cout,) f32, extra (temb (B, Cout) | residual (B, Cout, H, W), in x's
    dtype, or None) for ``mode`` 1 | 2 | 0. A bf16 call that ``conv_plan``
    splits takes an f32 workspace of (split, B, Cout, H, W). Returns y (B,
    Cout, H, W)."""
    b, cin, h, w = x.shape
    cout = weight_k.shape[0]
    a, c = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (a, c))
    y = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    split, workspace = 1, None
    if x.dtype == torch.bfloat16:
        split = conv_plan(b, cin, cout, h, w,
                          _sm_count(x.device.index or 0))["split"]
        if split > 1:
            workspace = torch.empty((split, b, cout, h, w),
                                    dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = _build.library("fused_conv").pcdms_fused_gn_silu_conv(
            x.data_ptr(), a.data_ptr(), c.data_ptr(), weight_k.data_ptr(),
            bias.data_ptr(), None if extra is None else extra.data_ptr(),
            y.data_ptr(),
            None if workspace is None else workspace.data_ptr(), b, cin,
            cout, h, w, mode, int(apply_act),
            int(x.dtype == torch.bfloat16), split, stream)
    _build.check(status, "pcdms_fused_gn_silu_conv")
    LAUNCHES["fused_gn_silu_conv"] += 1
    return y


def fused_gn_silu_conv(x, a, c, weight, bias, temb=None, residual=None,
                       apply_act: bool = True):
    """conv3x3(silu(x * a + c)) + bias (+ temb | + residual) on NCHW ``x``
    with the torch weight (Cout, Cin, 3, 3): the CUDA kernel for a CUDA
    tensor (or raise), the plain version for a CPU tensor."""
    if temb is not None and residual is not None:
        raise ValueError("give temb or residual, not both")
    if x.device.type == "cpu":
        return fused_gn_silu_conv_plain(x, a, c, weight, bias, temb, residual,
                                        apply_act)
    if not x.is_cuda:
        raise ValueError(f"the fused conv kernel takes CUDA tensors, got a "
                         f"tensor on {x.device}")
    extra, mode = None, _MODES["none"]
    if temb is not None:
        extra, mode = temb, _MODES["temb"]
    elif residual is not None:
        extra, mode = residual, _MODES["residual"]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, a, c, weight, bias, extra)):
        raise NotImplementedError(
            "the fused conv kernel has no backward (fused_conv is an "
            "inference option, as in the JAX package)")
    _check(x, a, c, weight, bias, extra)
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if extra is not None:
        want = (b, cout) if mode == _MODES["temb"] else (b, cout, h, w)
        if tuple(extra.shape) != want:
            raise ValueError(f"{'temb' if mode == 1 else 'residual'} must be "
                             f"{want}, got {tuple(extra.shape)}")
        extra = extra.to(x.dtype).contiguous()
    return launch_fused_conv(
        x.contiguous(), a.float().contiguous(), c.float().contiguous(),
        relaid_weight(weight, x.dtype), bias.float().contiguous(), extra,
        mode, apply_act)


def gn_silu_conv3x3(x, gn_scale, gn_shift, weight, bias, *,
                    num_groups: int = 32, eps: float = 1e-5, temb=None,
                    residual=None, apply_act: bool = True):
    """y = conv3x3(silu(groupnorm(x))) + bias [+ temb | + residual]
    (``gn_silu_conv3x3``). x: (B, Cin, H, W); weight: (Cout, Cin, 3, 3);
    bias: (Cout,); temb: optional (B, Cout); residual: optional
    (B, Cout, H, W). Output in x's dtype."""
    a, c = gn_affine_coeffs(x, gn_scale, gn_shift, num_groups, eps)
    return fused_gn_silu_conv(x, a, c, weight, bias, temb=temb,
                              residual=residual, apply_act=apply_act)
