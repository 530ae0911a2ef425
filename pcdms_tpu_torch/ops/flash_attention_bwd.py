"""Flash-attention backward: CUDA kernels, their plain versions.

Counterpart of ``pcdms_tpu/ops/flash_attention_bwd.py``. Its three Pallas
TPU kernels are hand-written CUDA C++ for Hopper here:

* ``flash_fwd_lse``: the online-softmax forward (``csrc/flash_attention.cu``)
  that also writes the per-row L = m + log2(l) of the exp2-domain scores;
* ``flash_bwd``: D = rowsum(dO o O) (a torch reduction, as JAX leaves it to
  XLA), then the dq kernel and the dk/dv kernel
  (``csrc/flash_attention_bwd.cu``), which rebuild P = exp2(s - L) tile by
  tile without an online rescale. In bf16 both are warp-specialised Hopper
  kernels (TMA copies into a shared-memory ring, ``wgmma`` products); a
  block owns 128 rows (q rows in dq, keys in dk/dv) and walks the other
  operand in tiles (``bwd_plan``).

Each wrapper launches its kernels for CUDA tensors (or raises) and takes the
plain PyTorch version, which repeats the kernels' arithmetic and roundings,
for CPU tensors. Launches are counted in ``flash_attention.LAUNCHES`` under
``flash_fwd_lse``, ``flash_dq`` and ``flash_dkv``. Tensors are (BH, L, 64).
"""

from __future__ import annotations

import torch

from pcdms_tpu_torch.ops import _build
from pcdms_tpu_torch.ops.flash_attention import (
    _LOG2E, LAUNCHES, _check, _check_scale, _online_softmax, _scores_log2,
)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def flash_fwd_lse_plain(q, k, v, scale: float):
    """``_fwd_lse_kernel``: the online forward (running max, alpha-rescale
    over 128-key tiles) and L = m + log2(max(l, 1e-30)), f32 (BH, Lq)."""
    acc, m, l = _online_softmax(q, k, v, scale)
    l = l.clamp_min(1e-30)
    return (acc / l).to(q.dtype), (m + torch.log2(l))[..., 0]


def row_dot(do, out):
    """D = rowsum(dO o O) in f32, (BH, Lq)."""
    return (do.float() * out.float()).sum(-1)


def _probs(q, k, v, lse2, do, dsum, scale: float):
    """P = exp2(s - L) (f32) and dS = P o (dO.v^T - D) rounded to the input
    dtype, as both backward kernels rebuild them."""
    p = torch.exp2(_scores_log2(q, k, scale) - lse2[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, (p * (dp - dsum[..., None])).to(q.dtype).float()


def flash_dq_plain(q, k, v, lse2, do, dsum, scale: float):
    """``_dq_kernel``: dq = scale . dS.k, f32 accumulation."""
    _, ds = _probs(q, k, v, lse2, do, dsum, scale)
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def flash_dkv_plain(q, k, v, lse2, do, dsum, scale: float):
    """``_dkv_kernel``: dk = scale . dS^T.q and dv = P^T.dO with P rounded
    to the input dtype, f32 accumulation."""
    p, ds = _probs(q, k, v, lse2, do, dsum, scale)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, out, lse2, do, scale: float):
    """The plain backward: D, then ``flash_dq_plain`` and
    ``flash_dkv_plain``."""
    dsum = row_dot(do, out)
    return (flash_dq_plain(q, k, v, lse2, do, dsum, scale),
            *flash_dkv_plain(q, k, v, lse2, do, dsum, scale))


# ---------------------------------------------------------------------------
# the bf16 kernels' tiling
# ---------------------------------------------------------------------------

# rows a block owns, and rows of the looped operand per ring stage (k / v in
# dq, q / dO in dk/dv); the constants of ``csrc/flash_attention_bwd.cu``
BLOCK_ROWS, _DQ_TILE, _DKV_TILE = 128, 128, 64


def bwd_plan(lq: int, lk: int, bh: int) -> dict:
    """How the two bf16 kernels cut (bh, lq, lk): per kernel the grid and
    the looped operand's tile and tile count. Block i of a head owns rows
    [i * BLOCK_ROWS, (i + 1) * BLOCK_ROWS) and writes those below the
    length; tile j holds looped rows [j * tile, (j + 1) * tile), zero past
    the length."""
    return {name: dict(grid=(-(-own // BLOCK_ROWS), bh), tile=tile,
                       tiles=-(-looped // tile))
            for name, own, looped, tile in (("dq", lq, lk, _DQ_TILE),
                                            ("dkv", lk, lq, _DKV_TILE))}


# ---------------------------------------------------------------------------
# kernel wrappers: CUDA tensor -> kernel (or raise), CPU tensor -> plain
# ---------------------------------------------------------------------------

def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd_lse(q, k, v, scale: float):
    """Forward with LSE on (BH, L, 64) tensors -> (out, lse2 (BH, Lq) f32)."""
    if q.device.type == "cpu":
        return flash_fwd_lse_plain(q, k, v, scale)
    _check_scale(q, scale)
    _check(q, k, v)
    out = torch.empty_like(q)
    lse2 = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        status = _build.library("flash_attention").pcdms_flash_fwd_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse2.data_ptr(), q.shape[0], q.shape[1], k.shape[1],
            scale * _LOG2E, int(q.dtype == torch.bfloat16), _stream(q))
    _build.check(status, "pcdms_flash_fwd_lse")
    LAUNCHES["flash_fwd_lse"] += 1
    return out, lse2


def launch_dq(q, k, v, lse2, do, dsum, scale: float):
    """The dq kernel alone (``flash_bwd`` checks the inputs); uncounted."""
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        status = _build.library("flash_attention_bwd").pcdms_flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), dsum.data_ptr(), dq.data_ptr(), q.shape[0],
            q.shape[1], k.shape[1], scale * _LOG2E, scale,
            int(q.dtype == torch.bfloat16), _stream(q))
    _build.check(status, "pcdms_flash_dq")
    return dq


def launch_dkv(q, k, v, lse2, do, dsum, scale: float):
    """The dk/dv kernel alone (``flash_bwd`` checks the inputs); uncounted."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        status = _build.library("flash_attention_bwd").pcdms_flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            q.shape[0], q.shape[1], k.shape[1], scale * _LOG2E, scale,
            int(q.dtype == torch.bfloat16), _stream(q))
    _build.check(status, "pcdms_flash_dkv")
    return dk, dv


def check_bwd_layout(q, out, lse2, do) -> None:
    """What the backward kernels need of ``out``, ``do`` and ``lse2`` beside
    q: q's shape, contiguous, at 16-byte aligned addresses (a tensor map
    takes nothing else); ``lse2`` a contiguous, 4-byte aligned f32 (BH, Lq)
    tensor on q's device. Raises ValueError otherwise."""
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} / do {tuple(do.shape)} "
                         f"must match q {tuple(q.shape)}")
    for name, t in (("out", out), ("do", do)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if (lse2.dtype != torch.float32 or lse2.shape != q.shape[:2]
            or not lse2.is_contiguous() or lse2.device != q.device
            or lse2.data_ptr() % 4):
        raise ValueError("lse2 must be a contiguous, aligned f32 (BH, Lq) "
                         "tensor on q's device")


def flash_bwd(q, k, v, out, lse2, do, scale: float):
    """Gradients (dq, dk, dv) of attention on (BH, L, 64) tensors, from the
    forward's ``out`` and ``lse2`` (``flash_fwd_lse``) and the output
    gradient ``do``."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse2, do, scale)
    _check(q, k, v)
    _check(out, do, do)
    check_bwd_layout(q, out, lse2, do)
    dsum = row_dot(do, out)
    dq = launch_dq(q, k, v, lse2, do, dsum, scale)
    LAUNCHES["flash_dq"] += 1
    dk, dv = launch_dkv(q, k, v, lse2, do, dsum, scale)
    LAUNCHES["flash_dkv"] += 1
    return dq, dk, dv
