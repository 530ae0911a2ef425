"""Flash attention: forward CUDA kernels, their plain versions, the router
and its differentiation.

Counterpart of ``pcdms_tpu/ops/flash_attention.py``. The three Pallas TPU
kernels there (frozen-max, online-softmax and short-kv) are hand-written
CUDA C++ for Hopper here (``csrc/flash_attention.cu``); in bf16 the
frozen-max and online kernels are warp-specialised (TMA copies into a
shared-memory ring, ``wgmma`` products; ``fwd_plan``), and so is the
short-kv kernel at head_dim 64 and 80, persistent with k and v resident
(``shortkv_plan``; it takes lk <= 512). Each has a wrapper
that launches the kernel for a CUDA tensor (or raises) and takes the plain
PyTorch version, which repeats the kernel's arithmetic, for a CPU tensor.
Each wrapper counts its launches in ``LAUNCHES`` (which also counts the
backward kernels of ``flash_attention_bwd`` and the fused conv of
``fused_conv``). The short-kv kernel takes head_dim 64 or 80 (CLIP ViT-H);
the others take 64, the head_dim of every path that reaches them.

The router ``flash_attention`` keeps the JAX package's routes and switches:

* lk <= 384 (the 258-token cross-attention, the mid block's 128 tokens)
  takes ``attention_reference``, unless ``PCDMS_SHORTKV=pallas`` selects
  the short-kv kernel;
* longer kv takes the frozen-max kernel, or the online-softmax kernel
  under ``PCDMS_FROZEN_MAX=0``; ``PCDMS_EXP_BF16=1`` demotes the online
  kernel's score tile to bf16 before max / exp2.

Under autograd (grad enabled and q, k or v requiring grad) the kernel
routes differentiate as the JAX package's ``custom_vjp``s do:
``_FlashFunction`` (``_flash_3d_diff``) runs the LSE forward kernel and the
dq and dk/dv kernels, ignoring ``PCDMS_FROZEN_MAX`` and ``PCDMS_EXP_BF16``
(the training path stays f32 softmax); ``_ShortKvFunction``
(``_shortkv_3d_diff``) keeps the short-kv forward kernel with the chunked
recompute backward. The reference route differentiates through plain
autograd.

The switches are read on every call. The TPU block picking (``_pick_blocks``,
``_Q_UNROLL``) has no counterpart: the kernels choose their own tiles.
"""

from __future__ import annotations

import functools
import math
import os

import torch

from pcdms_tpu_torch.ops import _build

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
# frozen-max headroom (exp2 domain) over the max of the first 128 scores:
# overflow then needs a later score ~104 nats above that estimate
_FROZEN_MARGIN = 24.0
_FROZEN_KEYS = 128
_SHORTKV_MAX = 384
# the bf16 frozen / online kernels' tiling (the constants of
# ``csrc/flash_attention.cu``): q rows a block, keys a ring stage, stages
FWD_BLOCK_ROWS, FWD_STAGE_KEYS, FWD_STAGES = 128, 128, 4
# the online kernel updates its running max once per stage; the plain online
# version walks the same step, so that each P is rounded where the kernel
# rounds it
_BLOCK_K = FWD_STAGE_KEYS
_HEAD_DIM = 64         # the kernels' head_dim
# the short-kv kernel also takes CLIP ViT-H's head_dim 80
_SHORTKV_HEAD_DIMS = (64, 80)
# the bf16 short-kv kernel (``csrc/flash_attention.cu``): q rows a (head, q
# tile) pair, keys of a full tile; k and v stay resident in shared memory,
# which holds SKV_MAX_KEYS of each
SKV_BLOCK_ROWS, SKV_TILE_KEYS, SKV_MAX_KEYS = 128, 128, 512
# keys of the tail tile's product, by how many keys the tail holds
_SKV_TAIL_WIDTHS = (16, 64, 128)
# the column parts of a row in shared memory, by head_dim: 64 columns in
# 128-byte-swizzled rows, at head_dim 80 (160-byte rows, wider than a
# 128-byte-swizzled copy) and the last 16 in 32-byte-swizzled rows
SKV_COLUMN_PARTS = {64: (64,), 80: (64, 16)}

# launches per kernel, read by chip_smoke.py: also those of the backward
# kernels (flash_attention_bwd) and of the fused conv (fused_conv)
LAUNCHES = {"flash_frozen": 0, "flash_online": 0, "flash_shortkv": 0,
            "flash_fwd_lse": 0, "flash_dq": 0, "flash_dkv": 0,
            "fused_gn_silu_conv": 0}
# the short-kv launches again, by head_dim
SHORTKV_LAUNCHES = {d: 0 for d in _SHORTKV_HEAD_DIMS}
_BWD_CHUNK = 256       # q rows per step of the short-kv route's backward


def reset_launches() -> None:
    for counts in (LAUNCHES, SHORTKV_LAUNCHES):
        for name in counts:
            counts[name] = 0


def attention_reference(q, k, v, scale=None):
    """Plain attention. q: (B, H, Lq, D), k/v: (B, H, Lk, D): f32 scores,
    softmax, p cast to v's dtype, f32 accumulate, output in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.softmax(s * scale, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# plain versions of the kernels, on (BH, L, D) tensors
# ---------------------------------------------------------------------------

def _scores_log2(q, k, scale):
    """f32 scores in the exp2 domain: q.k^T * scale * log2(e)."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        scale * _LOG2E)


def _normalised(p, v, dtype):
    """sum_j p_j v_j / max(sum_j p_j, 1e-30), with p rounded to v's dtype
    for both sums (the kernels' P.V operand) and f32 accumulation."""
    p = p.to(v.dtype).float()
    acc = torch.matmul(p, v.float())
    return (acc / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(dtype)


def flash_frozen_plain(q, k, v, scale: float):
    """``_flash_kernel_frozen``: the row max is fixed in advance at
    m0 = max(first <= 128 scores) + 24, so softmax is exp2(s - m0) / sum."""
    s = _scores_log2(q, k, scale)
    m0 = s[..., :_FROZEN_KEYS].amax(-1, keepdim=True) + _FROZEN_MARGIN
    return _normalised(torch.exp2(s - m0), v, q.dtype)


def shortkv_plain(q, k, v, scale: float):
    """``_shortkv_kernel``: one-pass softmax with the exact row max."""
    s = _scores_log2(q, k, scale)
    return _normalised(torch.exp2(s - s.amax(-1, keepdim=True)), v, q.dtype)


def _online_softmax(q, k, v, scale: float, exp_bf16: bool = False):
    """The online-softmax loop over k tiles of 128: returns the unnormalised
    f32 accumulator, the running max m and the row-sum l, (BH, Lq, 1)."""
    bh, lq, d = q.shape
    m = torch.full((bh, lq, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    acc = torch.zeros((bh, lq, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, lq, 1), dtype=torch.float32, device=q.device)
    for j in range(0, k.shape[1], _BLOCK_K):
        s = _scores_log2(q, k[:, j:j + _BLOCK_K], scale)
        if exp_bf16:
            sb = s.to(torch.bfloat16)
            m_new = torch.maximum(m, sb.float().amax(-1, keepdim=True))
            p = torch.exp2(sb - m_new.to(torch.bfloat16))
        else:
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        p = p.to(v.dtype).float()
        acc = acc * alpha + torch.matmul(p, v[:, j:j + _BLOCK_K].float())
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
    return acc, m, l


def flash_online_plain(q, k, v, scale: float, exp_bf16: bool = False):
    """``_flash_kernel``: running max and alpha-rescale over k tiles of 128.
    ``exp_bf16`` demotes each score tile to bf16 before max / exp2."""
    acc, _, l = _online_softmax(q, k, v, scale, exp_bf16)
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def fwd_plan(lq: int, lk: int, bh: int) -> dict:
    """How the bf16 frozen / online kernel cuts (bh, lq, lk): block i of a
    head owns q rows [i * block_rows, (i + 1) * block_rows) and writes those
    below lq; tile j holds keys [j * stage_keys, (j + 1) * stage_keys), zero
    past lk, and is one step of the online softmax; the frozen max is taken
    of tile 0."""
    return dict(grid=(-(-lq // FWD_BLOCK_ROWS), bh),
                block_rows=FWD_BLOCK_ROWS, stage_keys=FWD_STAGE_KEYS,
                stages=FWD_STAGES, tiles=-(-lk // FWD_STAGE_KEYS))


def shortkv_plan(lq: int, lk: int, bh: int, sms: int,
                 head_dim: int = _HEAD_DIM) -> dict:
    """How the bf16 short-kv kernel walks (bh, lq, lk). Pair i = head *
    q_tiles + tile owns q rows [tile * block_rows, (tile + 1) * block_rows)
    of its head. ``grid`` = min(sms, pairs) persistent blocks; block b walks
    the contiguous run ``runs[b]`` = [b * pairs // grid, (b + 1) * pairs //
    grid) and loads the head's k and v at ``reloads[b]``, the pairs of its
    run that start a head for it. The keys are ``full`` unmasked tiles of
    tile_keys, then a tail of the remaining 1..128 keys through a product
    ``tail_width`` wide, masked from lk on. Each row of q, k and v comes in
    ``column_parts`` (64, then 16 more at head_dim 80): Q.K^T takes a k-step
    of 16 columns per 16 of them, and P.V one product per part."""
    if head_dim not in SKV_COLUMN_PARTS:
        raise ValueError(f"the short-kv kernel takes head_dim "
                         f"{tuple(SKV_COLUMN_PARTS)}, got {head_dim}")
    q_tiles = -(-lq // SKV_BLOCK_ROWS)
    pairs = bh * q_tiles
    grid = min(sms, pairs)
    runs = [range(b * pairs // grid, (b + 1) * pairs // grid)
            for b in range(grid)]
    reloads = [[i for i in run if i == run.start
                or i // q_tiles != (i - 1) // q_tiles] for run in runs]
    full = (lk - 1) // SKV_TILE_KEYS
    tail = lk - full * SKV_TILE_KEYS
    return dict(grid=grid, block_rows=SKV_BLOCK_ROWS, q_tiles=q_tiles,
                pairs=pairs, runs=runs, reloads=reloads,
                tile_keys=SKV_TILE_KEYS, full=full, tail=tail,
                tail_width=next(w for w in _SKV_TAIL_WIDTHS if tail <= w),
                column_parts=SKV_COLUMN_PARTS[head_dim])


# ---------------------------------------------------------------------------
# kernel wrappers: CUDA tensor -> kernel (or raise), CPU tensor -> plain
# ---------------------------------------------------------------------------

def _check(q, k, v, head_dims=(_HEAD_DIM,)):
    for t in (q, k, v):
        if not t.is_cuda:
            raise ValueError(f"flash attention kernels take CUDA tensors, "
                             f"got a tensor on {t.device}")
        if t.dtype != q.dtype or t.dtype not in (torch.bfloat16,
                                                 torch.float32):
            raise TypeError(f"flash attention kernels take bf16 or f32 "
                            f"q/k/v of one dtype, got {t.dtype}")
        if t.dim() != 3 or t.shape[-1] not in head_dims:
            raise ValueError(f"this flash attention kernel takes (BH, L, D) "
                             f"tensors with D in {head_dims}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash attention kernels take contiguous, "
                             "16-byte aligned tensors")
        if t.device != q.device:
            raise ValueError("q, k and v must lie on one device")
    if k.shape != v.shape or k.shape[0] != q.shape[0]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("flash attention needs lq > 0 and lk > 0")


def _check_scale(q, scale: float) -> None:
    """The bf16 frozen / online / LSE kernel takes its row max of the raw
    products and scales it after: that needs a positive softmax scale. The
    f32 and short-kv kernels scale every score and take any."""
    if q.dtype == torch.bfloat16 and not scale > 0:
        raise ValueError(f"the bf16 flash attention kernels take a positive "
                         f"softmax scale, got {scale}")


def _check_shortkv_keys(k) -> None:
    """The bf16 short-kv kernel keeps a head's k and v resident in shared
    memory, SKV_MAX_KEYS of each; every short-kv call is held to that
    domain, and longer kv raises. The router sends at most 384 keys."""
    if k.shape[1] > SKV_MAX_KEYS:
        raise ValueError(f"the short-kv kernels take at most {SKV_MAX_KEYS} "
                         f"keys, got {k.shape[1]}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """SMs of CUDA device ``index``: the short-kv kernel's persistent grid."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(entry: str, q, k, v, scale: float, *extra,
            head_dims=(_HEAD_DIM,)):
    _check(q, k, v, head_dims)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = getattr(_build.library("flash_attention"), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.shape[0], q.shape[1], k.shape[1], scale * _LOG2E,
            int(q.dtype == torch.bfloat16), *extra, stream)
    _build.check(status, entry)
    return out


def flash_frozen(q, k, v, scale: float):
    """Frozen-max flash attention on (BH, L, 64) tensors."""
    if q.device.type == "cpu":
        return flash_frozen_plain(q, k, v, scale)
    _check_scale(q, scale)
    out = _launch("pcdms_flash_frozen", q, k, v, scale)
    LAUNCHES["flash_frozen"] += 1
    return out


def flash_online(q, k, v, scale: float, exp_bf16: bool = False):
    """Online-softmax flash attention on (BH, L, 64) tensors."""
    if q.device.type == "cpu":
        return flash_online_plain(q, k, v, scale, exp_bf16)
    _check_scale(q, scale)
    out = _launch("pcdms_flash_online", q, k, v, scale, int(exp_bf16))
    LAUNCHES["flash_online"] += 1
    return out


def shortkv_attention(q, k, v, scale: float):
    """Short-kv (one-pass softmax) attention on (BH, L, D) tensors, D = 64
    or 80."""
    if q.device.type == "cpu":
        return shortkv_plain(q, k, v, scale)
    _check_shortkv_keys(k)
    out = _launch("pcdms_flash_shortkv", q, k, v, scale, q.shape[-1],
                  _sm_count(q.device.index), head_dims=_SHORTKV_HEAD_DIMS)
    LAUNCHES["flash_shortkv"] += 1
    SHORTKV_LAUNCHES[q.shape[-1]] += 1
    return out


# ---------------------------------------------------------------------------
# differentiation
# ---------------------------------------------------------------------------

def chunked_bwd(q, k, v, out, do, scale: float):
    """Exact-recompute attention gradients over q chunks of 256
    (``_chunked_xla_bwd``): softmax rebuilt per chunk in f32, P and dS
    rounded to k's dtype before their products, f32 accumulation."""
    dt = k.dtype
    kf, vf = k.float(), v.float()
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    dqs = []
    for i in range(0, q.shape[1], _BWD_CHUNK):
        qc = q[:, i:i + _BWD_CHUNK].float()
        doc = do[:, i:i + _BWD_CHUNK].float()
        p = torch.softmax(torch.matmul(qc, kf.transpose(-1, -2)) * scale, -1)
        dp = torch.matmul(doc, vf.transpose(-1, -2))
        dsum = (doc * out[:, i:i + _BWD_CHUNK].float()).sum(-1, keepdim=True)
        ds = (p * (dp - dsum)).to(dt).float()
        dqs.append(torch.matmul(ds, kf) * scale)
        dk += torch.matmul(ds.transpose(-1, -2), qc) * scale
        dv += torch.matmul(p.to(dt).float().transpose(-1, -2), doc)
    return (torch.cat(dqs, 1).to(q.dtype), dk.to(dt), dv.to(v.dtype))


class _FlashFunction(torch.autograd.Function):
    """Flash attention on (BH, L, 64) tensors under autograd: LSE forward
    kernel, dq + dk/dv backward kernels (``_flash_3d_diff``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        # imported here: flash_attention_bwd imports this module
        from pcdms_tpu_torch.ops.flash_attention_bwd import flash_fwd_lse
        out, lse2 = flash_fwd_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse2)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        from pcdms_tpu_torch.ops.flash_attention_bwd import flash_bwd
        q, k, v, out, lse2 = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse2, do.contiguous(),
                               ctx.scale)
        return dq, dk, dv, None


class _ShortKvFunction(torch.autograd.Function):
    """Short-kv attention under autograd: the short-kv forward kernel, the
    chunked recompute backward (``_shortkv_3d_diff``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out = shortkv_attention(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        return (*chunked_bwd(q, k, v, out, do, ctx.scale), None)


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

def attention_route(lk: int) -> str:
    """Which route ``flash_attention`` takes for kv length ``lk`` without
    autograd: 'reference', 'shortkv', 'frozen' or 'online' (under autograd
    'frozen' and 'online' both take ``_FlashFunction``)."""
    if lk <= _SHORTKV_MAX:
        if os.environ.get("PCDMS_SHORTKV", "xla") == "pallas":
            return "shortkv"
        return "reference"
    if os.environ.get("PCDMS_FROZEN_MAX", "1") == "1":
        return "frozen"
    return "online"


def flash_attention(q, k, v, scale=None):
    """Multi-head attention. q: (B, H, Lq, D), k/v: (B, H, Lk, D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    route = attention_route(k.shape[2])
    if route == "reference":
        return attention_reference(q, k, v, scale)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    q3 = q.reshape(b * h, lq, d).contiguous()
    k3 = k.reshape(b * h, lk, d).contiguous()
    v3 = v.reshape(b * h, lk, d).contiguous()
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if route == "shortkv":
        out = (_ShortKvFunction.apply(q3, k3, v3, float(scale)) if grad
               else shortkv_attention(q3, k3, v3, float(scale)))
    elif grad:
        out = _FlashFunction.apply(q3, k3, v3, float(scale))
    elif route == "frozen":
        out = flash_frozen(q3, k3, v3, float(scale))
    else:
        exp_bf16 = os.environ.get("PCDMS_EXP_BF16", "0") == "1"
        out = flash_online(q3, k3, v3, float(scale), exp_bf16)
    return out.reshape(b, h, lq, d)


def flash_attention_packed(q, k, v, heads: int, scale=None,
                           use_flash: bool = True):
    """Attention on packed (B, L, H*D) tensors (the Linear projections'
    layout). ``use_flash=False`` takes ``attention_reference`` for every
    kv length."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // heads
    qh = q.reshape(b, lq, heads, d).transpose(1, 2)
    kh = k.reshape(b, lk, heads, d).transpose(1, 2)
    vh = v.reshape(b, lk, heads, d).transpose(1, 2)
    attn = flash_attention if use_flash else attention_reference
    o = attn(qh, kh, vh, scale)
    return o.transpose(1, 2).reshape(b, lq, hd)
