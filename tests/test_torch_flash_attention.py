"""The port's flash attention against the JAX package's.

On the CPU: the plain versions of the three CUDA kernels against the Pallas
kernels in interpret mode (as tests/test_flash_attention.py runs them), the
router's decisions, and the wrappers' refusal to run a kernel on a CPU
tensor, and the bf16 frozen / online kernel's tiling (``fwd_plan``) and
source as far as the CPU reaches them. The kernels themselves are held
against the plain versions on a card by tests/test_torch_kernels_cuda.py.
Bars: f32 2e-5, bf16 3e-2, the bf16-softmax variant 2e-2.
"""

import inspect
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdms_tpu.ops.flash_attention import (
    _flash_3d_diff, _shortkv_attention_3d,
    attention_reference as j_attention_reference,
)

from pcdms_tpu_torch.ops import flash_attention as fa

BARS = {"f32": 2e-5, "bf16": 3e-2}
SHAPES = [(256, 256), (256, 512), (300, 258), (640, 600)]
BH, D = 2, 64


def _qkv(lq, lk, seed, bh=BH, large=False):
    rng = np.random.default_rng(seed)
    if large:
        q = np.full((bh, lq, D), 8.0, np.float32)
        k = np.full((bh, lk, D), 8.0, np.float32)
    else:
        q = rng.standard_normal((bh, lq, D)).astype(np.float32)
        k = rng.standard_normal((bh, lk, D)).astype(np.float32)
    v = rng.standard_normal((bh, lk, D)).astype(np.float32)
    return q, k, v


def _cast(arrays, dtype):
    if dtype == "f32":
        return ([jnp.asarray(a) for a in arrays],
                [torch.from_numpy(a) for a in arrays])
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])


def _assert_close(got, want, bar):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=bar, rtol=bar)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lq,lk", SHAPES)
@pytest.mark.parametrize("kernel", ["frozen", "online"])
def test_plain_matches_pallas(kernel, lq, lk, dtype):
    scale = 1.0 / math.sqrt(D)
    (jq, jk, jv), (tq, tk, tv) = _cast(_qkv(lq, lk, lq + lk), dtype)
    want = _flash_3d_diff(jq, jk, jv, scale, 128, 128, True, False, 1,
                          kernel == "frozen")
    plain = (fa.flash_frozen_plain if kernel == "frozen"
             else fa.flash_online_plain)
    got = plain(tq, tk, tv, scale)
    assert got.dtype == tq.dtype
    _assert_close(got, want, BARS[dtype])


@pytest.mark.parametrize("lq,lk", [(256, 256), (300, 200)])
def test_plain_online_exp_bf16_matches_pallas(lq, lk):
    scale = 1.0 / math.sqrt(D)
    (jq, jk, jv), (tq, tk, tv) = _cast(_qkv(lq, lk, 7), "f32")
    want = _flash_3d_diff(jq, jk, jv, scale, 128, 128, True, True, 1, False)
    got = fa.flash_online_plain(tq, tk, tv, scale, exp_bf16=True)
    _assert_close(got, want, 2e-2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lk", [258, 100, 128, 257, 384])
def test_plain_shortkv_matches_pallas(lk, dtype):
    scale = 1.0 / math.sqrt(D)
    (jq, jk, jv), (tq, tk, tv) = _cast(_qkv(300, lk, lk), dtype)
    want = _shortkv_attention_3d(jq, jk, jv, scale, 128, True)
    _assert_close(fa.shortkv_plain(tq, tk, tv, scale), want, BARS[dtype])


# the partial-max inputs' offset of keys from 128 on, by head_dim: with q
# about 1, it lifts their scores by d x offset x log2(e) / sqrt(d), about
# 162 in the exp2 domain at either head_dim (64: 14.0, 80: 12.5)
PARTIAL_MAX_OFFSET = {64: 14.0, 80: 12.5}


def _shortkv_hard_qkv(kind, lq, lk, seed, bh=BH, d=D):
    """Inputs that random ones never make. 'partial_max': keys from 128 on
    score about 160 above keys 0-127 in the exp2 domain, so a max taken of
    the first 128 keys alone overflows exp2. 'all_negative': q positive, k
    negative, every score below -130 in the exp2 domain, so a zero key
    (score 0) in the max would underflow every real weight to 0."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.5, 1.5, (bh, lq, d)).astype(np.float32)
    v = rng.standard_normal((bh, lk, d)).astype(np.float32)
    if kind == "partial_max":
        k = 0.5 * rng.standard_normal((bh, lk, d)).astype(np.float32)
        k[:, 128:] += PARTIAL_MAX_OFFSET[d]
    else:
        k = -rng.uniform(14.0, 16.0, (bh, lk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("kind,lk,d", [
    pytest.param(kind, lk, d, id=f"{kind}-{lk}" + ("" if d == 64 else f"-d{d}"))
    for d in (64, 80)
    for kind, lk in [("partial_max", 258), ("partial_max", 384),
                     ("all_negative", 258), ("all_negative", 128)]]
    + [pytest.param("partial_max", 257, 80, id="partial_max-257-d80"),
       pytest.param("all_negative", 257, 80, id="all_negative-257-d80")])
def test_plain_shortkv_hard_inputs_match_pallas(kind, lk, d):
    """f32: the plain short-kv version and the Pallas kernel agree, finite,
    on inputs where only the exact max over every key (and no other) gives
    finite, non-zero weights, at head_dim 64 and at CLIP ViT-H's 80."""
    scale = 1.0 / math.sqrt(d)
    arrays = _shortkv_hard_qkv(kind, 200, lk, 31, d=d)
    s2 = np.einsum("bqd,bkd->bqk", arrays[0], arrays[1]) * scale * np.log2(
        np.e)
    if kind == "partial_max":
        assert (s2[..., 128:].max(-1) - s2[..., :128].max(-1)).min() > 128
    else:
        assert s2.max() < -130
    (jq, jk, jv), (tq, tk, tv) = _cast(arrays, "f32")
    got = fa.shortkv_plain(tq, tk, tv, scale)
    assert torch.isfinite(got).all() and got.abs().max() > 0.1
    _assert_close(got, _shortkv_attention_3d(jq, jk, jv, scale, 128, True),
                  BARS["f32"])


@pytest.mark.parametrize("kernel", ["frozen", "online", "shortkv"])
def test_plain_large_logits(kernel):
    """Equal, large logits: every variant stays finite and uniform."""
    q, k, v = _qkv(128, 128, 3, bh=1, large=True)
    scale = 1.0 / math.sqrt(D)
    plain = {"frozen": fa.flash_frozen_plain,
             "online": fa.flash_online_plain,
             "shortkv": fa.shortkv_plain}[kernel]
    got = plain(torch.from_numpy(q), torch.from_numpy(k),
                torch.from_numpy(v), scale)
    assert torch.isfinite(got).all()
    want = np.broadcast_to(v.mean(axis=1, keepdims=True), got.shape)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    (jq, jk, jv), _ = _cast((q, k, v), "f32")
    if kernel == "shortkv":
        jwant = _shortkv_attention_3d(jq, jk, jv, scale, 128, True)
    else:
        jwant = _flash_3d_diff(jq, jk, jv, scale, 128, 128, True, False, 1,
                               kernel == "frozen")
    _assert_close(got, jwant, 2e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_reference_matches_jax(dtype):
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal((2, 3, 40, D)).astype(np.float32),
              rng.standard_normal((2, 3, 33, D)).astype(np.float32),
              rng.standard_normal((2, 3, 33, D)).astype(np.float32)]
    (jq, jk, jv), (tq, tk, tv) = _cast(arrays, dtype)
    _assert_close(fa.attention_reference(tq, tk, tv),
                  j_attention_reference(jq, jk, jv), BARS[dtype])


def test_router_routes(monkeypatch):
    """Routes are decided from kv length and the switches alone."""
    for name in ("PCDMS_SHORTKV", "PCDMS_FROZEN_MAX", "PCDMS_EXP_BF16"):
        monkeypatch.delenv(name, raising=False)
    assert fa.attention_route(258) == "reference"
    assert fa.attention_route(384) == "reference"
    assert fa.attention_route(512) == "frozen"
    assert fa.attention_route(8192) == "frozen"
    monkeypatch.setenv("PCDMS_FROZEN_MAX", "0")
    assert fa.attention_route(8192) == "online"
    assert fa.attention_route(258) == "reference"
    monkeypatch.setenv("PCDMS_SHORTKV", "pallas")
    assert fa.attention_route(258) == "shortkv"
    assert fa.attention_route(385) == "online"


@pytest.mark.parametrize("env,plain", [
    ({}, "flash_frozen_plain"),
    ({"PCDMS_FROZEN_MAX": "0"}, "flash_online_plain"),
    ({"PCDMS_SHORTKV": "pallas"}, "shortkv_plain"),
])
def test_router_takes_plain_versions_on_cpu(monkeypatch, env, plain):
    """On CPU tensors the router runs the chosen kernel's plain version and
    launches nothing."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    lk = 258 if "PCDMS_SHORTKV" in env else 400
    q, k, v = (torch.from_numpy(a)[None] for a in _qkv(64, lk, 9))
    fa.reset_launches()
    got = fa.flash_attention(q, k, v)
    want = getattr(fa, plain)(q[0], k[0], v[0], 1.0 / math.sqrt(D))
    torch.testing.assert_close(got[0], want, atol=0, rtol=0)
    assert sum(fa.LAUNCHES.values()) == 0

    def pack(x):                    # (1, H, L, D) -> (1, L, H*D)
        return x.transpose(1, 2).reshape(1, x.shape[2], BH * D)

    packed = fa.flash_attention_packed(pack(q), pack(k), pack(v), heads=BH)
    unpacked = packed.reshape(1, 64, BH, D).transpose(1, 2)[0]
    torch.testing.assert_close(unpacked, want, atol=0, rtol=0)


def test_launch_refuses_cpu_tensors():
    """No hidden fallback: the kernel launcher raises on a CPU tensor
    instead of computing something else."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(64, 64, 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa._launch("pcdms_flash_frozen", q, k, v, 0.125)


@pytest.mark.parametrize("scale", [0.0, -0.125, float("nan")])
def test_launch_refuses_a_scale_that_is_not_positive(scale):
    """The bf16 frozen / online / LSE kernel scales its row max after taking
    it, which holds for a positive scale only: its wrappers raise on any
    other. The f32 and short-kv kernels scale every score and take any."""
    q = torch.from_numpy(_qkv(64, 64, 1)[0])
    with pytest.raises(ValueError, match="positive softmax scale"):
        fa._check_scale(q.to(torch.bfloat16), scale)
    fa._check_scale(q, scale)


@pytest.mark.parametrize("lk,ok", [(1, True), (384, True), (512, True),
                                   (513, False), (1024, False)])
def test_shortkv_refuses_more_keys_than_it_keeps(lk, ok):
    """The bf16 short-kv kernel keeps a head's k and v in shared memory, 512
    keys of each: its wrapper checks the kv length before the launch."""
    k = torch.zeros((2, lk, D), dtype=torch.bfloat16)
    if ok:
        fa._check_shortkv_keys(k)
    else:
        with pytest.raises(ValueError, match="at most 512 keys"):
            fa._check_shortkv_keys(k)


# ---------------------------------------------------------------------------
# the bf16 frozen / online kernel's tiling and source
# ---------------------------------------------------------------------------

_CSRC = Path(fa.__file__).resolve().parent / "csrc"


@pytest.mark.parametrize("bh,lq,lk", [
    (10, 8192, 8192), (20, 2048, 2048), (40, 512, 512),   # the UNet's levels
    (80, 8192, 8192), (10, 640, 600), (3, 129, 127), (3, 1, 64),
    (3, 70, 130), (3, 192, 8200), (3, 200, 100), (1, 1, 1)])
def test_fwd_plan_covers_every_row_once(bh, lq, lk):
    """The blocks own every q row exactly once, the ring's tiles hold every
    key exactly once, and neither a block nor a tile is empty."""
    plan = fa.fwd_plan(lq, lk, bh)
    assert plan["grid"][1] == bh
    rows, keys = plan["block_rows"], plan["stage_keys"]
    owned = np.zeros(lq, int)
    for i in range(plan["grid"][0]):
        owned[i * rows:(i + 1) * rows] += 1
    assert (owned == 1).all()
    assert (plan["grid"][0] - 1) * rows < lq
    walked = np.zeros(lk, int)
    for j in range(plan["tiles"]):
        walked[j * keys:(j + 1) * keys] += 1
    assert (walked == 1).all()
    assert (plan["tiles"] - 1) * keys < lk
    # the frozen max is taken of tile 0: the first min(lk, 128) keys
    assert min(lk, keys) == min(lk, fa._FROZEN_KEYS)


@pytest.mark.parametrize("bh,length,blocks,tiles", [
    (10, 8192, 64, 64), (20, 2048, 16, 16), (40, 512, 4, 4)])
def test_fwd_plan_at_the_unet_levels(bh, length, blocks, tiles):
    """128 q rows a block and 128 keys a stage at the UNet's three
    self-attention shapes: 640, 320 and 160 blocks."""
    assert fa.fwd_plan(length, length, bh) == dict(
        grid=(blocks, bh), block_rows=128, stage_keys=128, stages=4,
        tiles=tiles)
    assert blocks * bh in (640, 320, 160)


def test_fwd_plan_has_the_kernels_constants():
    """The plan's block rows, stage keys and stages are those the CUDA
    source compiles, and the plain online version walks the kernel's
    softmax step."""
    src = (_CSRC / "flash_attention.cu").read_text()
    hopper = (_CSRC / "hopper.cuh").read_text()
    assert "constexpr int kConsumers = 2;" in hopper
    assert "constexpr int kBlockRows = kConsumers * 64;" in hopper
    assert "using hp::kBlockRows;" in src
    assert fa.FWD_BLOCK_ROWS == 2 * 64
    assert (f"constexpr int kFwdKeys = {fa.FWD_STAGE_KEYS}, "
            f"kFwdStages = {fa.FWD_STAGES};") in src
    assert "constexpr int kFrozenKeys = 128;" in src
    assert fa._BLOCK_K == fa.FWD_STAGE_KEYS == fa._FROZEN_KEYS == 128
    # q and the ring fit the 227 KB a block may use
    ring = (fa.FWD_BLOCK_ROWS + 2 * fa.FWD_STAGES * fa.FWD_STAGE_KEYS) * 128
    assert ring + 4096 <= 227 * 1024


# (B*H, Lq, Lk) of the UNet's short-kv calls at batch 2: the 258-token
# cross-attention at the three levels and in the mid block, the mid block's
# 128-token self-attention; and level 0 at the batch test's UNet batch 16
SHORTKV_UNET = [(10, 8192, 258), (20, 2048, 258), (40, 512, 258),
                (40, 128, 258), (40, 128, 128), (80, 8192, 258)]
SHORTKV_RAGGED = [(3, lq, lk) for lq in (1, 127, 129)
                  for lk in (1, 127, 128, 129, 170, 257, 258, 300,
                            384, 390, 460, 512)]


def _assert_walks_every_pair_once(plan, bh, lq, lk, sms):
    tiles = plan["q_tiles"]
    assert tiles == -(-lq // 128) and plan["pairs"] == bh * tiles
    assert plan["grid"] == min(sms, bh * tiles) == len(plan["runs"])
    walked = np.zeros((bh, tiles), int)
    nxt = 0
    for run, reloads in zip(plan["runs"], plan["reloads"]):
        assert len(run) > 0 and run.start == nxt and run.step == 1
        nxt = run.stop
        heads = [i // tiles for i in run]
        for i in run:
            walked[i // tiles, i % tiles] += 1
        assert reloads[0] == run.start
        assert [i // tiles for i in reloads] == sorted(set(heads))
        assert all(i == run.start or (i - 1) // tiles != i // tiles
                   for i in reloads)
    assert nxt == plan["pairs"] and (walked == 1).all()
    # every q row belongs to one pair, and only the last tile is ragged
    assert (tiles - 1) * plan["block_rows"] < lq <= tiles * plan["block_rows"]
    full, tail, width = plan["full"], plan["tail"], plan["tail_width"]
    assert full * plan["tile_keys"] + tail == lk and 1 <= tail <= 128
    assert width == min(w for w in (16, 64, 128) if w >= tail)
    # the tail's product stays inside the resident k and v
    assert full * plan["tile_keys"] + width <= fa.SKV_MAX_KEYS


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("bh,lq,lk", SHORTKV_UNET + SHORTKV_RAGGED)
def test_shortkv_plan_walks_every_pair_once(bh, lq, lk, sms):
    """The persistent blocks walk every (head, q tile) pair exactly once in
    contiguous runs, no block is empty, and a block loads k and v at the
    first pair of its run and wherever its run crosses into the next head,
    nowhere else. The key tiles hold every key once: full 128-key tiles,
    then a tail no wider than its product."""
    plan = fa.shortkv_plan(lq, lk, bh, sms)
    _assert_walks_every_pair_once(plan, bh, lq, lk, sms)
    assert plan["column_parts"] == (64,)


# CLIP ViT-H's 257-token self-attention (16 heads of 80) over 2, 4 and 8
# images: the batch test's train mode, the JAX batch test's default
# --batch_size 4, the stage-2 trainer's --train_batch_size 8
SHORTKV_CLIP = [(32, 257, 257), (64, 257, 257), (128, 257, 257)]


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("bh,lq,lk", SHORTKV_CLIP + SHORTKV_RAGGED)
def test_shortkv_plan_walks_every_pair_once_at_head_dim_80(bh, lq, lk, sms):
    """The same walk at head_dim 80, whose rows come in a 64-column and a
    16-column part."""
    plan = fa.shortkv_plan(lq, lk, bh, sms, head_dim=80)
    _assert_walks_every_pair_once(plan, bh, lq, lk, sms)
    assert plan["column_parts"] == (64, 16) and sum(plan["column_parts"]) == 80


@pytest.mark.parametrize("bh,blocks,runs,crossing", [
    (32, 96, (1, 1), 0), (64, 132, (1, 2), 20), (128, 132, (2, 3), 84)])
def test_shortkv_plan_at_the_clip_shapes(bh, blocks, runs, crossing):
    """On an H100's 132 SMs: 257 tokens are three 128-row q tiles a head
    and two full key tiles with a 16-key tail; 96 pairs over 2 images leave
    36 SMs idle and load each head's k and v three times; 8 images give
    runs of 2-3 pairs and 132 + 84 loads for 128 heads."""
    plan = fa.shortkv_plan(257, 257, bh, 132, head_dim=80)
    assert plan["q_tiles"] == 3 and plan["pairs"] == 3 * bh
    assert plan["grid"] == blocks
    assert {len(r) for r in plan["runs"]} == set(runs)
    assert sum(len(r) - 1 for r in plan["reloads"]) == crossing
    assert (plan["full"], plan["tail"], plan["tail_width"]) == (2, 1, 16)


def test_shortkv_plan_refuses_other_head_dims():
    with pytest.raises(ValueError, match="head_dim"):
        fa.shortkv_plan(257, 257, 2, 132, head_dim=96)


@pytest.mark.parametrize("bh,lq,lk,blocks,runs,crossing,width", [
    (10, 8192, 258, 132, (4, 5), 6, 16), (20, 2048, 258, 132, (2, 3), 8, 16),
    (40, 512, 258, 132, (1, 2), 4, 16), (40, 128, 258, 40, (1, 1), 0, 16),
    (40, 128, 128, 40, (1, 1), 0, 128), (80, 8192, 258, 132, (38, 39), 76,
                                         16)])
def test_shortkv_plan_at_the_unet_shapes(bh, lq, lk, blocks, runs, crossing,
                                         width):
    """On an H100's 132 SMs: 640 pairs at level 0 in runs of 4-5, 6 of them
    crossing a head boundary (the other 3 boundaries fall between runs);
    the mid block's 40 pairs one a block; 258 keys are two full tiles and a
    16-key tail, 128 keys one 128-key tail."""
    plan = fa.shortkv_plan(lq, lk, bh, 132)
    assert plan["grid"] == blocks
    assert {len(r) for r in plan["runs"]} == set(runs)
    assert sum(len(r) - 1 for r in plan["reloads"]) == crossing
    assert plan["tail_width"] == width


def test_shortkv_plan_has_the_kernels_constants():
    """The plan's tiling is the one the CUDA source compiles; k and v of 512
    keys, two q stages and the tile of ones fit the 227 KB a block may
    use."""
    src = (_CSRC / "flash_attention.cu").read_text()
    assert "constexpr int kSkvTileKeys = 128;" in src
    assert "constexpr int kSkvMaxKeys = 4 * kSkvTileKeys;" in src
    assert "constexpr int kSkvQStages = 2;" in src
    assert fa.SKV_TILE_KEYS == 128 and fa.SKV_MAX_KEYS == 4 * 128
    assert fa.SKV_BLOCK_ROWS == fa.FWD_BLOCK_ROWS == 2 * 64
    for width in (16, 64, 128):
        assert f"launch_shortkv_tail<{width}>(" in src
    assert tuple(fa.SKV_COLUMN_PARTS) == fa._SHORTKV_HEAD_DIMS == (64, 80)
    assert "static_assert(sizeof(SkvSmem<80>) + 1024 <= 232448," in src
    for d, parts in fa.SKV_COLUMN_PARTS.items():
        assert sum(parts) == d
        # q of two pairs, k and v of 512 keys, the tile of ones (one k-step
        # of 64 columns), the barriers, the 16-column parts on a 1024-byte
        # boundary, and the 1024 bytes the base may move up
        smem = ((2 * fa.SKV_BLOCK_ROWS + 2 * fa.SKV_MAX_KEYS) * 2 * d
                + 16 * 128 + 64 + (1024 if d > 64 else 0) + 1024)
        assert smem <= 227 * 1024, d
    assert fa._SHORTKV_MAX <= fa.SKV_MAX_KEYS


def _section(src, start, end):
    return src[src.index(start):src.index(end)]


def test_bf16_forward_source_is_the_hopper_design():
    """The bf16 frozen / online kernel and the bf16 short-kv kernel at
    head_dim 64 and 80 run their products on wgmma and fill shared memory
    by TMA under mbarriers; no warp-level mma is left in the forward
    source; nothing reads the environment."""
    src = (_CSRC / "flash_attention.cu").read_text()
    assert '#include "hopper.cuh"' in src
    hopper_part = _section(src, "// bf16 frozen / online: TMA ring",
                           "// bf16 short-kv, head_dim 64 and 80:")
    skv_part = _section(src, "// bf16 short-kv, head_dim 64 and 80:",
                        "// f32, FMA: one thread per q row")
    for call in ("hp::wgmma_ss(", "hp::wgmma_rs(", "hp::tma_load_rows(",
                 "hp::mbar_wait(", "hp::reg_alloc<", "hp::store_slice(",
                 "hp::MapCache", "hp::allow_smem("):
        assert call in hopper_part, call
    for call in ("hp::wgmma_ss(", "hp::wgmma_rs(", "hp::tma_load_rows(",
                 "hp::mbar_wait(", "hp::reg_alloc<", "hp::store_slice(",
                 "hp::allow_smem(", "maps.encode(", "gridDim.x",
                 # head_dim 80: the 16-column parts and their products
                 "hp::make_desc16(", "hp::kStep16MN", "hp::store_slice16(",
                 "map_qx", "kCols16"):
        assert call in skv_part, call
    for gone in ("mma.sync", "mma_bf16(", "mma_abt", "mma_ab", "ldmatrix",
                 "load_tile_bf16", "load_a_frags", "tile_scores",
                 "flash_shortkv_bf16", "exp2f(", "getenv"):
        assert gone not in hopper_part and gone not in skv_part, gone
    for gone in ("mma.sync", "mma_abt", "mma_ab", "ldmatrix",
                 "load_tile_bf16", "load_a_frags", "tile_scores",
                 "flash_shortkv_bf16", "getenv"):
        assert gone not in src, gone
    # one template serves frozen, online, online[exp_bf16] and the LSE
    # forward, one the short-kv tails at head_dim 64 and 80, one the f32
    # kernels: three templates, lse a runtime pointer
    assert src.count("__global__") == 3
    for entry, mode in (("pcdms_flash_frozen", "launch<kFrozen, false>"),
                        ("pcdms_flash_fwd_lse", "launch<kOnline, false>")):
        body = src[src.index(f'extern "C" int {entry}('):]
        assert mode in body[:body.index("\n}\n")], entry
    # a bf16 call at head_dim 64 or 80 reaches the persistent kernel
    body = src[src.index('extern "C" int pcdms_flash_shortkv('):]
    body = body[:body.index("\n}\n")]
    for d in (64, 80):
        assert f"launch_shortkv_bf16<{d}>(" in body, d
    # and the helpers only the warp-level kernel used are gone from mma.cuh
    mma = (_CSRC / "mma.cuh").read_text()
    for gone in ("load_tile_bf16", "load_a_frags", "mma_abt", "mma_ab("):
        assert gone not in mma, gone


def test_shared_hopper_helpers_live_in_the_header_once():
    """Forward and backward sources share one copy of the ring, the
    epilogue and the tensor-map cache, which copies the map out."""
    hopper = (_CSRC / "hopper.cuh").read_text()
    sources = [(_CSRC / name).read_text() for name in
               ("flash_attention.cu", "flash_attention_bwd.cu")]
    for needle in ("struct Ring {", "struct MapCache {",
                   "Smem& shared_storage(", "void store_slice(",
                   "cudaError_t allow_smem(", "float ex2(float x)"):
        assert hopper.count(needle) == 1, needle
        for src in sources:
            assert needle not in src, needle
    assert "*out = s.map;" in hopper and "s.map = *out;" in hopper


@pytest.mark.parametrize("wrapper,plain,counter", [
    ("flash_frozen", "flash_frozen_plain", "flash_frozen"),
    ("flash_online", "flash_online_plain", "flash_online"),
    ("shortkv_attention", "shortkv_plain", "flash_shortkv")])
def test_wrappers_launch_or_raise_on_cuda(wrapper, plain, counter):
    """Past the CPU branch a wrapper launches its kernel and counts it: no
    route back to the plain version, no ``try``."""
    src = inspect.getsource(getattr(fa, wrapper))
    cuda_part = src.split(f"return {plain}", 1)[1]
    assert "_launch(" in cuda_part and f'LAUNCHES["{counter}"] += 1' in (
        cuda_part)
    assert "plain" not in cuda_part and "try" not in cuda_part
