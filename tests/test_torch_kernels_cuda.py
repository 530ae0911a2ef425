"""The CUDA kernels (flash attention, and the fused GroupNorm + SiLU +
conv3x3) against their plain PyTorch versions, on a card only (marker
``cuda``; they skip without one, since a CUDA kernel has no CPU form).
JAX-free, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Forward bars: f32 max abs error 2e-5; bf16 (and the bf16-softmax variant)
max abs error 1e-2 of the output's largest magnitude (also with inputs on
which only the short-kv kernel's exact row max stays finite), which admits the one
bf16 ulp (at most 2^-7 of a value) by which two accumulation orders may
round apart. Backward bars, each scaled to its output: bf16 max abs error
1e-2 of the largest magnitude and relative L2 5e-3; f32 max abs error 2e-5
of the largest magnitude; the LSE 1e-4 of its largest magnitude. The fused
conv: bf16 max abs error 1e-2 of the largest magnitude and relative L2
5e-3, f32 max abs error 2e-5 of the largest magnitude. The full-width
stage-3 UNet: eps relative L2 5e-2, kernels against plain attention and
fused convs against unfused ones.
"""

import math
import threading

import numpy as np
import pytest
import torch

from pcdms_tpu_torch.ops import flash_attention as fa
from pcdms_tpu_torch.ops import flash_attention_bwd as fb
from pcdms_tpu_torch.ops import fused_conv as fc

D = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, dtype, bh, lq, lk, seed=11, d=D):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((bh, n, d), generator=gen, device=dev).to(dtype)
            for n in (lq, lk, lk)]


def _run(kernel, q, k, v, scale):
    if kernel == "frozen":
        return fa.flash_frozen(q, k, v, scale), fa.flash_frozen_plain(
            q, k, v, scale)
    if kernel == "shortkv":
        return fa.shortkv_attention(q, k, v, scale), fa.shortkv_plain(
            q, k, v, scale)
    eb = kernel == "online_exp_bf16"
    return (fa.flash_online(q, k, v, scale, eb),
            fa.flash_online_plain(q, k, v, scale, eb))


# on both sides of the bf16 frozen / online kernel's 128-row blocks and
# 128-key ring stages, and fewer keys than the 128 the frozen max is taken of
FWD_EDGES = [(129, 127), (127, 129), (200, 100), (385, 513), (1, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(300, 600), (128, 128), (64, 1)]
                         + FWD_EDGES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["frozen", "online", "online_exp_bf16",
                                    "shortkv"])
def test_kernel_matches_plain(cuda, kernel, dtype, lq, lk):
    if kernel == "shortkv":
        lk = min(lk, 258)
    q, k, v = _qkv(cuda, dtype, 3, lq, lk)
    fa.reset_launches()
    got, want = _run(kernel, q, k, v, 1.0 / math.sqrt(D))
    torch.cuda.synchronize()
    assert sum(fa.LAUNCHES.values()) == 1
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32 and kernel != "online_exp_bf16":
        bar = 2e-5
    else:
        bar = 1e-2 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= bar


def _fwd_kernels(q, k, v, scale):
    """The three bf16 wgmma forward variants, the LSE forward and, where kv
    is short enough, the persistent short-kv kernel: name -> tuple of
    outputs."""
    out = {"frozen": (fa.flash_frozen(q, k, v, scale),),
           "online": (fa.flash_online(q, k, v, scale),),
           "online_exp_bf16": (fa.flash_online(q, k, v, scale, True),),
           "fwd_lse": fb.flash_fwd_lse(q, k, v, scale)}
    if k.shape[1] <= fa.SKV_MAX_KEYS:
        out["shortkv"] = (fa.shortkv_attention(q, k, v, scale),)
    return out


def _fwd_plains(q, k, v, scale):
    out = {"frozen": (fa.flash_frozen_plain(q, k, v, scale),),
           "online": (fa.flash_online_plain(q, k, v, scale),),
           "online_exp_bf16": (fa.flash_online_plain(q, k, v, scale, True),),
           "fwd_lse": fb.flash_fwd_lse_plain(q, k, v, scale)}
    if k.shape[1] <= fa.SKV_MAX_KEYS:
        out["shortkv"] = (fa.shortkv_plain(q, k, v, scale),)
    return out


def _assert_fwd_matches(got, want):
    for name in want:
        out, p_out = got[name][0], want[name][0]
        assert out.dtype == p_out.dtype and out.shape == p_out.shape
        assert torch.isfinite(out).all(), name
        assert _max_rel(out, p_out) <= 1e-2, name
    lse2, p_lse2 = got["fwd_lse"][1], want["fwd_lse"][1]
    assert lse2.dtype == torch.float32 and lse2.shape == p_lse2.shape
    assert _max_rel(lse2, p_lse2) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", FWD_EDGES + [(70, 130), (192, 8200),
                                               (2048, 1100)])
def test_lse_forward_matches_plain(cuda, lq, lk):
    """The LSE forward (the online kernel with its per-row L) in bf16 on
    both sides of the block and stage sizes."""
    q, k, v = _qkv(cuda, torch.bfloat16, 3, lq, lk)
    scale = 1.0 / math.sqrt(D)
    fa.reset_launches()
    out, lse2 = fb.flash_fwd_lse(q, k, v, scale)
    torch.cuda.synchronize()
    assert {n: c for n, c in fa.LAUNCHES.items() if c} == {"flash_fwd_lse": 1}
    p_out, p_lse2 = fb.flash_fwd_lse_plain(q, k, v, scale)
    assert torch.isfinite(out).all() and torch.isfinite(lse2).all()
    assert _max_rel(out, p_out) <= 1e-2
    assert _max_rel(lse2, p_lse2) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
@pytest.mark.parametrize("lq,lk", [(70, 130), (129, 127), (200, 60),
                                   (300, 600), (129, 258), (300, 384)])
def test_forward_kernels_never_read_the_neighbouring_head(cuda, monkeypatch,
                                                          lq, lk, bad):
    """Heads share one buffer: with every value of heads 0 and 2 set to Inf
    or NaN, head 1's output is that of head 1 alone, bit for bit. A tile
    that ran past a ragged length into the next head's rows would carry
    them into a max or a product. The short-kv kernel runs on 2 SMs here,
    so that a persistent block's run crosses from head to head and reloads
    k and v on the way."""
    monkeypatch.setattr(fa, "_sm_count", lambda index: 2)
    q, k, v = _qkv(cuda, torch.bfloat16, 1, lq, lk)
    three = []
    for x in (q, k, v):
        y = torch.full((3, *x.shape[1:]), bad, dtype=x.dtype, device=cuda)
        y[1] = x[0]
        three.append(y)
    scale = 1.0 / math.sqrt(D)
    alone = _fwd_kernels(q, k, v, scale)
    among = _fwd_kernels(*three, scale)
    torch.cuda.synchronize()
    for name, outs in alone.items():
        for a, b in zip(outs, among[name]):
            assert torch.isfinite(b[1]).all(), name
            assert torch.equal(a[0], b[1]), name
    _assert_fwd_matches(alone, _fwd_plains(q, k, v, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("bh,lq,lk", [(3, 129, 127), (4, 2048, 1100)])
def test_forward_kernels_are_deterministic(cuda, bh, lq, lk):
    """Two calls on the same inputs give the same bits."""
    q, k, v = _qkv(cuda, torch.bfloat16, bh, lq, lk)
    scale = 1.0 / math.sqrt(D)
    first = _fwd_kernels(q, k, v, scale)
    second = _fwd_kernels(q, k, v, scale)
    torch.cuda.synchronize()
    for name, outs in first.items():
        for a, b in zip(outs, second[name]):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_forward_kernels_across_many_live_tensors(cuda):
    """The launcher keeps the last few tensor maps; more live q / k / v sets
    than it keeps, visited in turn, still give each set its own result."""
    scale = 1.0 / math.sqrt(D)
    sets = [_qkv(cuda, torch.bfloat16, 2, 100 + 7 * i, 90 + 5 * i,
                 seed=20 + i) for i in range(7)]
    first = [_fwd_kernels(*x, scale) for x in sets]
    for _ in range(2):
        for x, want in zip(sets, first):
            got = _fwd_kernels(*x, scale)
            for name, outs in want.items():
                for g, w in zip(got[name], outs):
                    assert torch.equal(g, w), name
    _assert_fwd_matches(first[3], _fwd_plains(*sets[3], scale))


# the UNet's short-kv calls at batch 2 (the 258-token cross-attention at
# the three levels and in the mid block, the mid block's self-attention) and
# level 0 at the batch test's UNet batch 16; ragged lengths on both sides of
# the 128-row pairs and the 128-key tiles, up to the 512 keys k and v may
# hold, with every tail width (16, 64, 128 keys) behind 0 to 3 full tiles
SHORTKV_UNET = [(10, 8192, 258), (20, 2048, 258), (40, 512, 258),
                (40, 128, 258), (40, 128, 128), (80, 8192, 258)]
SHORTKV_RAGGED = [(3, lq, lk) for lq in (1, 127, 129)
                  for lk in (1, 127, 128, 129, 170, 257, 258, 300,
                            384, 390, 460, 512)]


def _assert_shortkv_matches(q, k, v, scale):
    fa.reset_launches()
    got = fa.shortkv_attention(q, k, v, scale)
    want = fa.shortkv_plain(q, k, v, scale)
    torch.cuda.synchronize()
    d = q.shape[-1]
    assert fa.SHORTKV_LAUNCHES == {64: int(d == 64), 80: int(d == 80)}
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    assert _max_rel(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("bh,lq,lk", SHORTKV_UNET)
def test_shortkv_kernel_at_the_unet_shapes(cuda, bh, lq, lk):
    """The persistent bf16 short-kv kernel at head_dim 64 on the card's own
    SMs at the shapes the UNet gives it."""
    _assert_shortkv_matches(*_qkv(cuda, torch.bfloat16, bh, lq, lk), 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("bh,lq,lk", SHORTKV_RAGGED)
def test_shortkv_kernel_at_ragged_shapes(cuda, monkeypatch, bh, lq, lk, sms):
    """Ragged q and kv lengths, on 1 and 7 SMs too: one block walks every
    head, or runs cross heads mid-way and reload k and v."""
    monkeypatch.setattr(fa, "_sm_count", lambda index: sms)
    _assert_shortkv_matches(*_qkv(cuda, torch.bfloat16, bh, lq, lk), 0.125)


# the partial-max inputs' offset of keys from 128 on, by head_dim: with q
# about 1 it lifts their scores by d x offset x log2(e) / sqrt(d), about 162
# in the exp2 domain at either head_dim (64: 14.0, 80: 12.5)
PARTIAL_MAX_OFFSET = {64: 14.0, 80: 12.5}


def _shortkv_hard(dev, kind, bh, lq, lk, seed=16, d=D):
    """'partial_max': keys from 128 on score about 160 above keys 0-127 in
    the exp2 domain, so a max taken of tile 0 alone overflows exp2.
    'all_negative': q positive, k negative, every score below -130, so a
    zero-filled key (score 0) in the max would underflow every weight."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.rand((bh, lq, d), generator=gen, device=dev) + 0.5
    v = torch.randn((bh, lk, d), generator=gen, device=dev)
    if kind == "partial_max":
        k = 0.5 * torch.randn((bh, lk, d), generator=gen, device=dev)
        k[:, 128:] += PARTIAL_MAX_OFFSET[d]
    else:
        k = -(torch.rand((bh, lk, d), generator=gen, device=dev) * 2 + 14)
    return [x.to(torch.bfloat16) for x in (q, k, v)]


def _assert_hard(q, k, v, kind, scale):
    """The inputs are as hard as _shortkv_hard says, then the kernel
    matches its plain version on them."""
    s2 = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        scale * math.log2(math.e))
    if kind == "partial_max":
        gap = s2[..., 128:].amax(-1) - s2[..., :128].amax(-1)
        assert gap.min().item() > 128
    else:
        assert s2.max().item() < -130
    del s2
    _assert_shortkv_matches(q, k, v, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,bh,lq,lk", [
    ("partial_max", 3, 300, 258), ("partial_max", 3, 129, 384),
    ("partial_max", 3, 129, 512), ("partial_max", 10, 8192, 258),
    ("all_negative", 3, 300, 258), ("all_negative", 3, 129, 128),
    ("all_negative", 10, 8192, 258)])
def test_shortkv_kernel_takes_the_exact_max(cuda, kind, bh, lq, lk):
    """The row max is taken of every key below lk and of no key past it:
    inputs on which a partial max overflows and a max that counts the
    zero-filled keys underflows, held to the plain version's output."""
    _assert_hard(*_shortkv_hard(cuda, kind, bh, lq, lk), kind, 0.125)


# CLIP ViT-H's 257-token self-attention, 16 heads of 80, over 2, 4 and 8
# images (the batch test's train mode, the JAX batch test's default
# --batch_size 4, the stage-2 trainer's --train_batch_size 8)
SHORTKV_CLIP = [(32, 257, 257), (64, 257, 257), (128, 257, 257)]
SCALE_80 = 1.0 / math.sqrt(80)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,lq,lk", SHORTKV_CLIP)
def test_shortkv_kernel_at_the_clip_shapes(cuda, bh, lq, lk):
    """The persistent bf16 short-kv kernel at head_dim 80 on the card's own
    SMs at the shapes CLIP ViT-H gives it."""
    _assert_shortkv_matches(*_qkv(cuda, torch.bfloat16, bh, lq, lk, d=80),
                            SCALE_80)


@pytest.mark.cuda
@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("bh,lq,lk", SHORTKV_RAGGED)
def test_shortkv_kernel_at_ragged_shapes_head_dim_80(cuda, monkeypatch, bh,
                                                     lq, lk, sms):
    """Ragged q and kv lengths at head_dim 80 (every tail width behind 0-3
    full tiles), on 1 and 7 SMs too, where runs cross heads and reload k
    and v with their 16-column parts."""
    monkeypatch.setattr(fa, "_sm_count", lambda index: sms)
    _assert_shortkv_matches(*_qkv(cuda, torch.bfloat16, bh, lq, lk, d=80),
                            SCALE_80)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,bh,lq,lk", [
    ("partial_max", 3, 300, 258), ("partial_max", 3, 129, 384),
    ("partial_max", 3, 129, 512), ("partial_max", 32, 257, 257),
    ("partial_max", 128, 257, 257), ("all_negative", 3, 300, 258),
    ("all_negative", 3, 129, 128), ("all_negative", 128, 257, 257)])
def test_shortkv_kernel_takes_the_exact_max_at_head_dim_80(cuda, kind, bh,
                                                           lq, lk):
    """The exact row max at head_dim 80, where the fifth k-step (the last
    16 columns) is part of every score."""
    _assert_hard(*_shortkv_hard(cuda, kind, bh, lq, lk, d=80), kind,
                 SCALE_80)


@pytest.mark.cuda
def test_shortkv_head_dims_on_the_same_storage(cuda):
    """Calls at head_dim 64 and 80 alternate on the same storage (the same
    base, heads and lengths), over more tensor sets than the tensor-map
    cache holds: a cached map of 64-wide rows is never taken for an 80-wide
    tensor, nor the other way round."""
    sets = []
    for i in range(5):
        gen = torch.Generator(device=cuda).manual_seed(40 + i)
        lq, lk = 130 + 9 * i, 200 + 11 * i
        flat = [torch.randn(3 * n * 80, generator=gen, device=cuda)
                .to(torch.bfloat16) for n in (lq, lk, lk)]
        sets.append({d: [t[:3 * n * d].view(3, n, d)
                         for t, n in zip(flat, (lq, lk, lk))]
                     for d in (64, 80)})
    first = {}
    for _ in range(2):
        for i, x in enumerate(sets):
            for d in (64, 80):
                scale = 1.0 / math.sqrt(d)
                fa.reset_launches()
                got = fa.shortkv_attention(*x[d], scale)
                torch.cuda.synchronize()
                assert fa.SHORTKV_LAUNCHES[d] == 1
                if (i, d) in first:
                    assert torch.equal(got, first[i, d]), (i, d)
                else:
                    first[i, d] = got
                    want = fa.shortkv_plain(*x[d], scale)
                    assert _max_rel(got, want) <= 1e-2, (i, d)


@pytest.mark.cuda
def test_shortkv_launches_by_head_dim(cuda):
    """Each short-kv call counts once, under its head_dim: bf16 and f32 at
    64 (the persistent kernel and the FMA one), bf16 at 80."""
    fa.reset_launches()
    for dtype in (torch.bfloat16, torch.float32):
        fa.shortkv_attention(*_qkv(cuda, dtype, 2, 70, 258), 0.125)
    gen = torch.Generator(device=cuda).manual_seed(17)
    q, k, v = (torch.randn((2, n, 80), generator=gen, device=cuda)
               .to(torch.bfloat16) for n in (70, 257, 257))
    fa.shortkv_attention(q, k, v, 1.0 / math.sqrt(80))
    torch.cuda.synchronize()
    assert fa.SHORTKV_LAUNCHES == {64: 2, 80: 1}
    assert {n: c for n, c in fa.LAUNCHES.items() if c} == {"flash_shortkv": 3}


@pytest.mark.cuda
def test_shortkv_refuses_more_keys_than_it_keeps(cuda):
    """More than 512 keys raise before a launch; 512 run."""
    fa.reset_launches()
    with pytest.raises(ValueError, match="at most 512 keys"):
        fa.shortkv_attention(*_qkv(cuda, torch.bfloat16, 1, 64, 513), 0.125)
    assert fa.LAUNCHES["flash_shortkv"] == 0
    _assert_shortkv_matches(*_qkv(cuda, torch.bfloat16, 1, 64, 512), 0.125)


@pytest.mark.cuda
def test_shortkv_refuses_more_keys_than_it_keeps_at_head_dim_80(cuda):
    """The same at head_dim 80, whose k and v of 512 keys take 160 KB."""
    fa.reset_launches()
    with pytest.raises(ValueError, match="at most 512 keys"):
        fa.shortkv_attention(
            *_qkv(cuda, torch.bfloat16, 1, 64, 513, d=80), SCALE_80)
    assert fa.LAUNCHES["flash_shortkv"] == 0
    _assert_shortkv_matches(*_qkv(cuda, torch.bfloat16, 1, 64, 512, d=80),
                            SCALE_80)


@pytest.mark.cuda
def test_kernel_refuses_unsupported_inputs(cuda):
    q, k, v = _qkv(cuda, torch.float16, 1, 64, 64)
    with pytest.raises(TypeError):
        fa.flash_frozen(q, k, v, 0.125)
    q, k, v = _qkv(cuda, torch.bfloat16, 1, 64, 64)
    with pytest.raises(ValueError):
        fa.flash_frozen(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous(), 0.125)
    with pytest.raises(ValueError):
        fa.flash_frozen(q.transpose(1, 2), k, v, 0.125)


def _max_rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def _assert_grads_match(grads, p_grads, dtype):
    for got, want in zip(grads, p_grads):
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.isfinite(got).all()
        if dtype == torch.bfloat16:
            assert _max_rel(got, want) <= 1e-2
            assert _rel_l2(got, want) <= 5e-3
        else:
            assert _max_rel(got, want) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("bh,lq,lk", [
    (3, 640, 600), (3, 70, 130), (3, 128, 128), (3, 64, 65), (3, 1, 130),
    # on both sides of the 128-row blocks and the 64- / 128-row ring stages
    (3, 129, 127), (3, 1, 64), (2, 8192, 8192), (3, 192, 8200)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_kernels_match_plain(cuda, dtype, bh, lq, lk):
    """LSE forward, dq and dk/dv against their plain versions; ragged lq
    and lk exercise the masked rows and columns."""
    q, k, v = _qkv(cuda, dtype, bh, lq, lk)
    do = _qkv(cuda, dtype, bh, lq, lq, seed=12)[0]
    scale = 1.0 / math.sqrt(D)
    fa.reset_launches()
    out, lse2 = fb.flash_fwd_lse(q, k, v, scale)
    grads = fb.flash_bwd(q, k, v, out, lse2, do, scale)
    torch.cuda.synchronize()
    assert {n: c for n, c in fa.LAUNCHES.items() if c} == {
        "flash_fwd_lse": 1, "flash_dq": 1, "flash_dkv": 1}
    p_out, p_lse2 = fb.flash_fwd_lse_plain(q, k, v, scale)
    p_grads = fb.flash_bwd_plain(q, k, v, p_out, p_lse2, do, scale)
    assert lse2.dtype == torch.float32 and lse2.shape == q.shape[:2]
    assert _max_rel(lse2, p_lse2) <= 1e-4
    bf16 = dtype == torch.bfloat16
    assert _max_rel(out, p_out) <= (1e-2 if bf16 else 2e-5)
    _assert_grads_match(grads, p_grads, dtype)


def _bwd_inputs(dev, bh, lq, lk):
    """bf16 q, k, v, dO with the LSE and D of the plain forward."""
    q, k, v = _qkv(dev, torch.bfloat16, bh, lq, lk)
    do = _qkv(dev, torch.bfloat16, bh, lq, lq, seed=12)[0]
    scale = 1.0 / math.sqrt(D)
    out, lse2 = fb.flash_fwd_lse_plain(q, k, v, scale)
    return q, k, v, lse2, do, fb.row_dot(do, out), scale


@pytest.mark.cuda
@pytest.mark.parametrize("bh,lq,lk", [(3, 129, 127), (3, 1, 64), (2, 64, 3),
                                      (3, 320, 200), (5, 1030, 520)])
def test_backward_kernels_alone_match_plain(cuda, bh, lq, lk):
    """The bf16 dq and dk/dv kernels alone, from the plain forward's LSE."""
    args = _bwd_inputs(cuda, bh, lq, lk)
    grads = (fb.launch_dq(*args), *fb.launch_dkv(*args))
    torch.cuda.synchronize()
    want = (fb.flash_dq_plain(*args), *fb.flash_dkv_plain(*args))
    _assert_grads_match(grads, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(70, 130), (129, 127), (200, 60)])
def test_backward_kernels_never_read_the_neighbouring_head(cuda, lq, lk):
    """Heads share one buffer: with every value of heads 0 and 2 set to Inf,
    head 1's gradients are those of head 1 alone, bit for bit. A tile that
    ran past a ragged length into the next head's rows would carry Inf."""
    one = _bwd_inputs(cuda, 1, lq, lk)
    three = []
    for x in one[:-1]:
        y = torch.full((3, *x.shape[1:]), float("inf"), dtype=x.dtype,
                       device=cuda)
        y[1] = x[0]
        three.append(y)
    scale = one[-1]
    alone = (fb.launch_dq(*one), *fb.launch_dkv(*one))
    among = (fb.launch_dq(*three, scale), *fb.launch_dkv(*three, scale))
    torch.cuda.synchronize()
    want = (fb.flash_dq_plain(*one), *fb.flash_dkv_plain(*one))
    for a, b in zip(alone, among):
        assert torch.isfinite(b[1]).all()
        assert torch.equal(a[0], b[1])
    _assert_grads_match(alone, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,lq,lk", [(3, 129, 127), (4, 2048, 1100)])
def test_backward_kernels_are_deterministic(cuda, bh, lq, lk):
    """No atomics: two calls on the same inputs give the same bits."""
    q, k, v, lse2, do, _, scale = _bwd_inputs(cuda, bh, lq, lk)
    out = fb.flash_fwd_lse(q, k, v, scale)[0]
    first = fb.flash_bwd(q, k, v, out, lse2, do, scale)
    second = fb.flash_bwd(q, k, v, out, lse2, do, scale)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_backward_kernels_across_many_live_tensors(cuda):
    """The launcher keeps the last few tensor maps; more live tensor sets
    than it keeps, visited in turn, still give each set its own result."""
    sets = [_bwd_inputs(cuda, 2, 100 + 7 * i, 90 + 5 * i) for i in range(7)]
    first = [(fb.launch_dq(*a), *fb.launch_dkv(*a)) for a in sets]
    for _ in range(2):
        for a, want in zip(sets, first):
            got = (fb.launch_dq(*a), *fb.launch_dkv(*a))
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    a = sets[3]
    _assert_grads_match(first[3], (fb.flash_dq_plain(*a),
                                   *fb.flash_dkv_plain(*a)), torch.bfloat16)


@pytest.mark.cuda
def test_backward_refuses_bad_layouts(cuda):
    """A CUDA tensor reaches the kernels or raises: ``do`` and ``lse2`` must
    be contiguous and aligned (a tensor map takes nothing else)."""
    q, k, v, lse2, do, _, scale = _bwd_inputs(cuda, 2, 64, 64)
    out = fb.flash_fwd_lse(q, k, v, scale)[0]
    flat = torch.zeros(do.numel() + 8, dtype=do.dtype, device=cuda)
    misaligned = flat[1:1 + do.numel()].view_as(do)
    wide = torch.zeros((2, 64, 2), device=cuda)
    for bad_do, bad_lse2 in ((do.transpose(1, 2), lse2), (misaligned, lse2),
                             (do, wide[..., 0]), (do, lse2[:, :32])):
        with pytest.raises(ValueError):
            fb.flash_bwd(q, k, v, out, bad_lse2, bad_do, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("route,lk,launched", [
    ("flash", 600, {"flash_fwd_lse": 1, "flash_dq": 1, "flash_dkv": 1}),
    ("shortkv", 258, {"flash_shortkv": 1})])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_through_kernels_matches_plain_route(cuda, monkeypatch,
                                                      dtype, route, lk,
                                                      launched):
    """Backward through the router on CUDA tensors reaches q, k and v
    through the kernels (the LSE, dq and dk/dv kernels; the short-kv kernel
    with its torch backward under PCDMS_SHORTKV=pallas), and the gradients
    equal those of plain attention in f32 (relative L2 2e-2 in bf16, 1e-4
    in f32)."""
    monkeypatch.setenv("PCDMS_SHORTKV", "pallas" if route == "shortkv"
                       else "xla")
    q, k, v = (x.reshape(1, 3, *x.shape[1:]) for x in
               _qkv(cuda, dtype, 3, 640, lk))
    do = _qkv(cuda, dtype, 3, 640, 640, seed=13)[0].reshape(1, 3, 640, D)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = [x.float().clone().requires_grad_() for x in (q, k, v)]
    fa.reset_launches()
    out = fa.flash_attention(*leaves)
    out.backward(do)
    torch.cuda.synchronize()
    assert {n: c for n, c in fa.LAUNCHES.items() if c} == launched
    fa.attention_reference(*ref).backward(do.float())
    bar = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for got, want in zip(leaves, ref):
        assert got.grad is not None and got.grad.dtype == dtype
        assert _rel_l2(got.grad, want.grad) <= bar


@pytest.mark.cuda
def test_inference_routing_unchanged(cuda):
    """Without autograd the long-kv route still launches the frozen kernel
    only."""
    q, k, v = (x.reshape(1, 3, *x.shape[1:]) for x in
               _qkv(cuda, torch.bfloat16, 3, 512, 512))
    fa.reset_launches()
    with torch.no_grad():
        fa.flash_attention(q.requires_grad_(), k, v)
    assert {n: c for n, c in fa.LAUNCHES.items() if c} == {"flash_frozen": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(257, 257), (300, 100), (64, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_shortkv_head_dim_80_matches_plain(cuda, dtype, lq, lk):
    """CLIP ViT-H's head_dim 80 through the short-kv kernel."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    q, k, v = (torch.randn((3, m, 80), generator=gen, device=cuda).to(dtype)
               for m in (lq, lk, lk))
    fa.reset_launches()
    got = fa.shortkv_attention(q, k, v, 1.0 / math.sqrt(80))
    want = fa.shortkv_plain(q, k, v, 1.0 / math.sqrt(80))
    torch.cuda.synchronize()
    assert fa.SHORTKV_LAUNCHES == {64: 0, 80: 1}
    assert got.dtype == dtype and got.shape == q.shape
    bar = (2e-5 if dtype == torch.float32
           else 1e-2 * want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= bar


def _conv_inputs(dev, dtype, b, h, w, cin, cout, mode, seed=15):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = (rand(b, cin, h, w) * 2 + 0.3).to(dtype)
    a, c = rand(b, cin).abs() + 0.5, rand(b, cin) * 0.3
    weight = (rand(cout, cin, 3, 3) / math.sqrt(9 * cin)).to(dtype)
    bias = rand(cout).to(dtype)
    temb = rand(b, cout).to(dtype) if mode == "temb" else None
    res = rand(b, cout, h, w).to(dtype) if mode == "residual" else None
    return x, a, c, weight, bias, temb, res


def _assert_conv_matches(got, want, dtype):
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    if dtype == torch.bfloat16:
        assert _max_rel(got, want) <= 1e-2 and _rel_l2(got, want) <= 5e-3
    else:
        assert _max_rel(got, want) <= 2e-5


# (B, H, W, Cin, Cout) beyond the first three (ragged pixels and channels,
# Cout > 128): split-K over 8 and over 2 blocks, Cin 200 (four chunks, the
# last of 8 channels) split over 4 with W = 40 (the third column of 16-wide
# tiles cut at the border) and with W = 20 (not a multiple of 8: pixel by
# pixel stores), a 3 x 5 image inside one tile
CONV_EDGES = [(1, 8, 16, 1280, 1280), (2, 16, 32, 640, 1280),
              (1, 20, 40, 200, 200), (3, 5, 20, 200, 320),
              (1, 3, 5, 64, 160)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "temb", "residual", "no_act"])
@pytest.mark.parametrize("shape", [(2, 8, 16, 64, 128), (3, 7, 9, 40, 24),
                                   (1, 16, 32, 320, 200)] + CONV_EDGES,
                         ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_conv_matches_plain(cuda, dtype, shape, mode):
    """The fused conv kernel in every mode, at a ragged shape (pixels and
    output channels that fill no tile), at one with Cout > 128, and at the
    split-K, Cin-not-a-multiple-of-64, border and small shapes."""
    torch.backends.cudnn.allow_tf32 = False
    x, a, c, weight, bias, temb, res = _conv_inputs(cuda, dtype, *shape,
                                                    mode)
    act = mode != "no_act"
    fa.reset_launches()
    got = fc.fused_gn_silu_conv(x, a, c, weight, bias, temb, res, act)
    want = fc.fused_gn_silu_conv_plain(x, a, c, weight, bias, temb, res, act)
    torch.cuda.synchronize()
    assert {n: k for n, k in fa.LAUNCHES.items() if k} == {
        "fused_gn_silu_conv": 1}
    _assert_conv_matches(got, want, dtype)


# the 14 resnet convs of the full-width stage-2 UNet (64x128 latents), in
# the mode the UNet uses there (Cin == Cout: conv2 with the shortcut)
UNET_CONVS = [(64, 128, 320, 320), (64, 128, 640, 320), (64, 128, 960, 320),
              (32, 64, 320, 640), (32, 64, 640, 640), (32, 64, 960, 640),
              (32, 64, 1280, 640), (32, 64, 1920, 640),
              (16, 32, 640, 1280), (16, 32, 1280, 1280),
              (16, 32, 1920, 1280), (16, 32, 2560, 1280),
              (8, 16, 1280, 1280), (8, 16, 2560, 1280)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", UNET_CONVS, ids=str)
def test_fused_conv_at_the_unet_shapes(cuda, shape):
    """bf16 at batch 2, as one UNet forward calls it (16x32 and 8x16 take
    split-K)."""
    h, w, cin, cout = shape
    mode = "residual" if cin == cout else "temb"
    x, a, c, weight, bias, temb, res = _conv_inputs(
        cuda, torch.bfloat16, 2, h, w, cin, cout, mode, seed=16)
    got = fc.fused_gn_silu_conv(x, a, c, weight, bias, temb, res)
    want = fc.fused_gn_silu_conv_plain(x, a, c, weight, bias, temb, res)
    torch.cuda.synchronize()
    _assert_conv_matches(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 16, 32, 64, 160), (2, 9, 17, 40, 24),
                                   (1, 8, 16, 1280, 160)], ids=str)
def test_fused_conv_zeroes_the_border_after_silu(cuda, shape):
    """With c = 3 every activated value is near 3, SiLU(c) far from 0: a
    window pixel outside the image that is not zeroed after the activation
    moves the outputs of the image's border rows and columns. Each border
    (first and last row, first and last column) is held to the bar on its
    own, and so is the interior."""
    b, h, w, cin, cout = shape
    x, a, _, weight, bias, _, _ = _conv_inputs(cuda, torch.bfloat16, *shape,
                                               "none", seed=17)
    c = torch.full_like(a, 3.0)
    a = a * 0.1
    got = fc.fused_gn_silu_conv(x, a, c, weight, bias)
    want = fc.fused_gn_silu_conv_plain(x, a, c, weight, bias)
    torch.cuda.synchronize()
    bar = 1e-2 * want.float().abs().max().item()
    for part in (np.s_[..., 0, :], np.s_[..., -1, :], np.s_[..., :, 0],
                 np.s_[..., :, -1], np.s_[..., 1:-1, 1:-1]):
        err = (got[part].float() - want[part].float()).abs().max().item()
        assert err <= bar, part


@pytest.mark.cuda
def test_fused_conv_across_many_live_weights(cuda):
    """The launcher keeps the last eight weight maps; twelve live weights
    (two Cin, two Cout) visited in turn, twice, still give each its own
    result, equal to the plain version's."""
    torch.backends.cudnn.allow_tf32 = False
    sets = [_conv_inputs(cuda, torch.bfloat16, 1, 8, 16, 64 + 64 * (i % 2),
                         160 + 160 * (i % 3 == 0), "residual", seed=30 + i)
            for i in range(12)]
    first = [fc.fused_gn_silu_conv(*s) for s in sets]
    for _ in range(2):
        for s, want in zip(sets, first):
            assert torch.equal(fc.fused_gn_silu_conv(*s), want)
    for s, got in zip(sets, first):
        _assert_conv_matches(got, fc.fused_gn_silu_conv_plain(*s),
                             torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 32, 64, 160),
                                   (2, 8, 16, 1280, 1280)], ids=str)
def test_fused_conv_is_deterministic(cuda, shape):
    """The split-K partial sums are added in a fixed order: two calls give
    the same bits."""
    args = _conv_inputs(cuda, torch.bfloat16, *shape, "residual", seed=18)
    assert torch.equal(fc.fused_gn_silu_conv(*args),
                       fc.fused_gn_silu_conv(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 32, 64, 160),
                                   (2, 8, 16, 1280, 1280)], ids=str)
def test_fused_conv_in_a_cuda_graph(cuda, shape):
    """A launch captured in a CUDA graph (with the split-K workspace of the
    second shape allocated in the capture) replays on new inputs copied
    into the captured ones."""
    x, a, c, weight, bias, temb, _ = _conv_inputs(cuda, torch.bfloat16,
                                                  *shape, "temb", seed=19)
    fc.fused_gn_silu_conv(x, a, c, weight, bias, temb)   # build, maps
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = fc.fused_gn_silu_conv(x, a, c, weight, bias, temb)
    for seed in (20, 21):
        x2, a2, c2, _, _, t2, _ = _conv_inputs(cuda, torch.bfloat16, *shape,
                                               "temb", seed=seed)
        for dst, src in ((x, x2), (a, a2), (c, c2), (temb, t2)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        _assert_conv_matches(y, fc.fused_gn_silu_conv_plain(
            x, a, c, weight, bias, temb), torch.bfloat16)


@pytest.mark.cuda
def test_fused_conv_follows_an_in_place_weight_update(cuda):
    """The re-laid weight is kept per weight version: after an in-place
    update the kernel reads the new weight."""
    x, a, c, weight, bias, temb, _ = _conv_inputs(cuda, torch.bfloat16, 2,
                                                  16, 32, 64, 160, "temb")
    before = fc.fused_gn_silu_conv(x, a, c, weight, bias, temb)
    weight.mul_(-0.5)
    after = fc.fused_gn_silu_conv(x, a, c, weight, bias, temb)
    torch.cuda.synchronize()
    assert not torch.equal(before, after)
    _assert_conv_matches(after, fc.fused_gn_silu_conv_plain(
        x, a, c, weight, bias, temb), torch.bfloat16)


@pytest.mark.cuda
def test_fused_conv_under_autograd_raises(cuda):
    """No backward: a CUDA call that autograd would record raises, and never
    returns a tensor cut from the graph."""
    x, a, c, weight, bias, temb, _ = _conv_inputs(cuda, torch.bfloat16, 1, 8,
                                                  8, 16, 16, "temb")
    with pytest.raises(NotImplementedError):
        fc.gn_silu_conv3x3(x.requires_grad_(), torch.ones(16, device=cuda),
                           torch.zeros(16, device=cuda), weight, bias,
                           num_groups=4, temb=temb)
    w = torch.nn.Parameter(weight)
    with pytest.raises(NotImplementedError):
        fc.fused_gn_silu_conv(x.detach(), a, c, w, bias)
    with torch.no_grad():
        assert fc.fused_gn_silu_conv(x.detach(), a, c, w, bias).shape == (
            1, 16, 8, 8)


@pytest.mark.cuda
def test_fused_conv_refuses_outside_its_domain(cuda):
    x, a, c, weight, bias, _, _ = _conv_inputs(cuda, torch.bfloat16, 1, 8, 8,
                                               12, 16, "none")
    with pytest.raises(ValueError):          # Cin not a multiple of 8
        fc.fused_gn_silu_conv(x, a, c, weight, bias)
    with pytest.raises(TypeError):
        fc.fused_gn_silu_conv(x.half(), a, c, weight, bias)


# ---------------------------------------------------------------------------
# the stage-3 shapes (512x512 images: 64x64 latents, square levels)
# ---------------------------------------------------------------------------

# the frozen kernel's self-attentions, (B*H, L, L): 4096 tokens with 5 heads
# and 1024 with 10, at CFG batch 2 and at the batch test's UNet batch 8
STAGE3_SELF = [(10, 4096, 4096), (20, 1024, 1024), (40, 4096, 4096),
               (80, 1024, 1024)]
# the short-kv kernel's calls at CFG batch 2: the 257-token cross-attention
# on the conditional half at the four levels, the 16x16 level's and the
# 8x8 mid block's self-attention
STAGE3_SHORTKV = [(5, 4096, 257), (10, 1024, 257), (20, 256, 257),
                  (20, 64, 257), (40, 256, 256), (40, 64, 64)]
STAGE3_CONVS = [(h, h, cin, cout) for h, _, cin, cout in UNET_CONVS]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,lq,lk", STAGE3_SELF)
def test_frozen_kernel_at_the_stage3_shapes(cuda, bh, lq, lk):
    q, k, v = _qkv(cuda, torch.bfloat16, bh, lq, lk, seed=40)
    fa.reset_launches()
    got, want = _run("frozen", q, k, v, 0.125)
    torch.cuda.synchronize()
    assert {n: c for n, c in fa.LAUNCHES.items() if c} == {
        "flash_frozen": 1}
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert _max_rel(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("bh,lq,lk", STAGE3_SHORTKV)
def test_shortkv_kernel_at_the_stage3_shapes(cuda, bh, lq, lk):
    _assert_shortkv_matches(
        *_qkv(cuda, torch.bfloat16, bh, lq, lk, seed=41), 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STAGE3_CONVS, ids=str)
def test_fused_conv_at_the_stage3_shapes(cuda, shape):
    """bf16 at batch 2 as the stage-3 UNet calls it: square levels down to
    8x8, an image narrower than the kernel's 16-pixel tile, split-K at the
    small levels."""
    h, w, cin, cout = shape
    mode = "residual" if cin == cout else "temb"
    x, a, c, weight, bias, temb, res = _conv_inputs(
        cuda, torch.bfloat16, 2, h, w, cin, cout, mode, seed=42)
    got = fc.fused_gn_silu_conv(x, a, c, weight, bias, temb, res)
    want = fc.fused_gn_silu_conv_plain(x, a, c, weight, bias, temb, res)
    torch.cuda.synchronize()
    _assert_conv_matches(got, want, torch.bfloat16)


# kernels 4-6 at the stage-3 trainer's self-attentions, (B*H, L, L): 512x512
# images at batch 2 (5 heads at 4096 tokens, 10 at 1024) and at the CLI's
# default batch 16
STAGE3_TRAIN = [(10, 4096, 4096), (20, 1024, 1024), (80, 4096, 4096),
                (160, 1024, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,lq,lk", STAGE3_TRAIN)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_kernels_at_the_stage3_training_shapes(cuda, dtype, bh, lq,
                                                        lk):
    """The LSE forward, dq and dk/dv against their plain versions at the
    shapes the stage-3 UNet gives them under autograd."""
    q, k, v = _qkv(cuda, dtype, bh, lq, lk, seed=45)
    do = _qkv(cuda, dtype, bh, lq, lq, seed=46)[0]
    scale = 1.0 / math.sqrt(D)
    fa.reset_launches()
    out, lse2 = fb.flash_fwd_lse(q, k, v, scale)
    grads = fb.flash_bwd(q, k, v, out, lse2, do, scale)
    torch.cuda.synchronize()
    assert {n: c for n, c in fa.LAUNCHES.items() if c} == {
        "flash_fwd_lse": 1, "flash_dq": 1, "flash_dkv": 1}
    p_out, p_lse2 = fb.flash_fwd_lse_plain(q, k, v, scale)
    assert _max_rel(lse2, p_lse2) <= 1e-4
    assert _max_rel(out, p_out) <= (1e-2 if dtype == torch.bfloat16
                                    else 2e-5)
    del p_out
    dsum = fb.row_dot(do, out)
    p_grads = (fb.flash_dq_plain(q, k, v, lse2, do, dsum, scale),
               *fb.flash_dkv_plain(q, k, v, lse2, do, dsum, scale))
    _assert_grads_match(grads, p_grads, dtype)


@pytest.fixture(scope="module")
def stage3_unet():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    from pcdms_tpu_torch.models.unet2d import (
        UNet2DConditionModel, stage3_unet_config,
    )
    torch.manual_seed(43)
    with torch.device("cuda"):
        unet = UNet2DConditionModel(stage3_unet_config())
    yield unet.to(torch.bfloat16).eval()
    del unet
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("route,launched", [
    ("default", {"flash_frozen": 10}),
    ("shortkv", {"flash_frozen": 10, "flash_shortkv": 22}),
    ("fused_conv", {"flash_frozen": 10, "fused_gn_silu_conv": 44})])
def test_stage3_unet_through_the_kernels(cuda, stage3_unet, monkeypatch,
                                         route, launched):
    """The full-width 8-channel stage-3 UNet at 64x64 latents, CFG batch 2,
    bf16: eps through the kernels against plain attention (default and
    PCDMS_SHORTKV=pallas routes), and with every resnet conv fused against
    the unfused forward, each with its launches counted."""
    import dataclasses
    gen = torch.Generator(device=cuda).manual_seed(44)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(
            torch.bfloat16)

    sample, ctx = rand(2, 64, 64, 8), rand(2, 257, 1024)
    ctx[:1] = 0
    ts = torch.tensor([500, 500], device=cuda)
    unet = stage3_unet
    base = unet.cfg

    def eps(**changes):
        unet.cfg = dataclasses.replace(base, **changes)
        try:
            with torch.inference_mode():
                return unet(sample, ts, ctx, zero_ctx_prefix=1)
        finally:
            unet.cfg = base

    if route == "shortkv":
        monkeypatch.setenv("PCDMS_SHORTKV", "pallas")
    fa.reset_launches()
    got = eps(fused_conv=route == "fused_conv")
    torch.cuda.synchronize()
    assert {n: c for n, c in fa.LAUNCHES.items() if c} == launched
    monkeypatch.delenv("PCDMS_SHORTKV", raising=False)
    want = eps() if route == "fused_conv" else eps(use_flash=False)
    assert got.shape == (2, 64, 64, 4) and torch.isfinite(got).all()
    assert _rel_l2(got, want) <= 5e-2


@pytest.fixture(scope="module")
def reduced_stage2_unet():
    """The stage-2 UNet at full width cut to one layer per block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    import dataclasses
    from pcdms_tpu_torch.models.unet2d import (
        UNet2DConditionModel, stage2_unet_config,
    )
    torch.manual_seed(45)
    with torch.device("cuda"):
        unet = UNet2DConditionModel(dataclasses.replace(
            stage2_unet_config(), layers_per_block=1))
    yield unet.to(torch.bfloat16).eval()
    del unet
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_decode_only_step_through_the_kernels(cuda, reduced_stage2_unet):
    """A decode-only step of encoder propagation (64x128 latents, CFG batch
    2, bf16): a fresh time embedding and the up blocks on features an
    encode cached at another timestep. Kernel 1 launches the up blocks'
    6 (two transformers in each of the three attention up blocks, all above
    384 tokens), the cached features are left as they were, and eps matches
    the same step under plain attention within rel L2 5e-2."""
    import dataclasses
    gen = torch.Generator(device=cuda).manual_seed(46)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(
            torch.bfloat16)

    sample, pose = rand(2, 64, 128, 9), rand(2, 64, 128, 320)
    ctx, labels = rand(2, 258, 1024), rand(2, 1024)
    ctx[:1] = 0
    labels[:1] = 0
    unet = reduced_stage2_unet
    base = unet.cfg

    def embed(t):
        return unet.time_embed(torch.full((2,), t, device=cuda), labels,
                               None, torch.bfloat16)

    with torch.inference_mode():
        h, skips = unet.encode(sample, embed(801), ctx, pose, 1)
        kept = [s.clone() for s in skips]
        fa.reset_launches()
        got = unet.decode(h, skips, embed(701), ctx, 1)
        torch.cuda.synchronize()
        launched = {n: c for n, c in fa.LAUNCHES.items() if c}
        unet.cfg = dataclasses.replace(base, use_flash=False)
        try:
            want = unet.decode(h, skips, embed(701), ctx, 1)
        finally:
            unet.cfg = base
    assert launched == {"flash_frozen": 6}
    assert all(torch.equal(a, b) for a, b in zip(skips, kept))
    assert got.shape == (2, 64, 128, 4) and torch.isfinite(got).all()
    assert _rel_l2(got, want) <= 5e-2


@pytest.mark.cuda
def test_cold_build_from_two_threads(cuda, tmp_path, monkeypatch):
    """Two threads (a server's engine threads) launch the frozen kernel at
    once on an empty build dir: the lock lets one build run, each library
    is built once, no temporary file is left behind, and both results
    agree with the plain version."""
    from pcdms_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LOADED", {})
    q, k, v = _qkv(cuda, torch.bfloat16, 10, 512, 512)
    scale = 1.0 / math.sqrt(D)
    results, errors = [None, None], []
    start = threading.Barrier(2)

    def launch(i):
        try:
            start.wait(30)
            results[i] = fa.flash_frozen(q, k, v, scale)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert len(list(tmp_path.glob("*.so"))) == len(_build._ENTRIES)
    assert not list(tmp_path.glob("*.tmp"))
    want = fa.flash_frozen_plain(q, k, v, scale).float()
    for got in results:
        err = (got.float() - want).abs().max().item()
        assert err <= 1e-2 * want.abs().max().item()


def _fresh_thread(fn):
    """Run ``fn`` in a new host thread; -> its result (or raise its
    exception)."""
    out = []

    def run():
        try:
            out.append(fn())
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 -- re-raised below
            out.append(e)

    th = threading.Thread(target=run)
    th.start()
    th.join(300)
    assert not th.is_alive() and len(out) == 1
    if isinstance(out[0], Exception):
        raise out[0]
    return out[0]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["frozen", "online", "shortkv", "shortkv80",
                                    "lse", "dq", "dkv", "fused_conv"])
def test_kernels_launch_from_fresh_threads(cuda, kernel):
    """Each bf16 Hopper kernel launched as the first CUDA work of new host
    threads, one after another (tensors from the caching allocator's reuse,
    so nothing else binds the thread's context first): every launch right.
    The tensor-map encoding of a thread's first launch needs the context
    that ``make_tensor_map`` binds."""
    d = 80 if kernel == "shortkv80" else D
    q, k, v = _qkv(cuda, torch.bfloat16, 3, 200, 130, d=d)
    scale = 1.0 / math.sqrt(d)
    if kernel in ("frozen", "online", "shortkv", "shortkv80"):
        name = "shortkv" if kernel.startswith("shortkv") else kernel
        got, want = _run(name, q, k, v, scale)
        launch = {"frozen": lambda: fa.flash_frozen(q, k, v, scale),
                  "online": lambda: fa.flash_online(q, k, v, scale),
                  "shortkv": lambda: fa.shortkv_attention(q, k, v, scale)}[
                      name]
    elif kernel == "lse":
        want = fb.flash_fwd_lse_plain(q, k, v, scale)[0]
        launch = lambda: fb.flash_fwd_lse(q, k, v, scale)[0]  # noqa: E731
    elif kernel in ("dq", "dkv"):
        o, lse2 = fb.flash_fwd_lse(q, k, v, scale)
        do = torch.randn_like(o)
        dsum = fb.row_dot(do, o)
        want = fb.flash_bwd_plain(q, k, v, o, lse2, do, scale)[
            0 if kernel == "dq" else 1]
        launch = (lambda: fb.launch_dq(q, k, v, lse2, do, dsum, scale)
                  if kernel == "dq" else
                  fb.launch_dkv(q, k, v, lse2, do, dsum, scale)[0])
    else:
        # f32 a / c / bias and a bf16 temb: the wrapper converts nothing, and
        # the first call re-lays the weight, so a thread's launch is its
        # first CUDA work
        x, a, c, w, b, temb, _ = _conv_inputs(cuda, torch.bfloat16, 2, 8,
                                              16, 64, 128, "temb")
        b = b.float()
        want = fc.fused_gn_silu_conv_plain(x, a, c, w, b, temb)
        fc.fused_gn_silu_conv(x, a, c, w, b, temb)
        launch = lambda: fc.fused_gn_silu_conv(x, a, c, w, b, temb)  # noqa
    for _ in range(3):
        got = _fresh_thread(launch)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-2 * want.float().abs().max().item()
