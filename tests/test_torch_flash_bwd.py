"""The port's flash-attention backward against the JAX package's.

On the CPU: the plain versions of the three backward CUDA kernels (LSE
forward, dq, dk/dv) against the Pallas kernels in interpret mode (as
tests/test_flash_bwd.py runs them), and ``torch.autograd`` through the
port's ``flash_attention`` on each route against ``jax.grad`` through the
JAX ``flash_attention(..., interpret=True)``. The kernels themselves are
held against the plain versions on a card by tests/test_torch_kernels_cuda.py.
Bar: f32 atol 1e-4, rtol 1e-3.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdms_tpu.ops.flash_attention import (
    _chunked_xla_bwd, flash_attention as j_flash_attention,
)
from pcdms_tpu.ops.flash_attention_bwd import (
    flash_bwd as j_flash_bwd, flash_fwd_lse as j_flash_fwd_lse,
)

from pcdms_tpu_torch.ops import flash_attention as fa
from pcdms_tpu_torch.ops import flash_attention_bwd as fb

from _torch_common import TOL, n, t

SCALE = 0.25


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _qkvdo(lq, lk, d, seed=3, bh=2):
    return _arrays([(bh, lq, d), (bh, lk, d), (bh, lk, d), (bh, lq, d)],
                   seed)


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("lq,lk", [(128, 128), (192, 256), (70, 130)])
def test_plain_fwd_lse_and_bwd_match_pallas(lq, lk, d):
    q, k, v, do = _qkvdo(lq, lk, d)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jout, jl2 = j_flash_fwd_lse(jq, jk, jv, SCALE, 64, 64, interpret=True)
    out, l2 = fb.flash_fwd_lse(t(q), t(k), t(v), SCALE)
    assert out.shape == q.shape and l2.shape == q.shape[:2]
    assert l2.dtype == torch.float32
    np.testing.assert_allclose(n(out), n(jout), **TOL)
    np.testing.assert_allclose(n(l2), n(jl2)[:, :lq], **TOL)

    jdq, jdk, jdv = j_flash_bwd(jq, jk, jv, jout, jl2, jdo, SCALE,
                                block_q=64, block_k=64, interpret=True)
    dq, dk, dv = fb.flash_bwd(t(q), t(k), t(v), out, l2, t(do), SCALE)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.shape == want.shape
        np.testing.assert_allclose(n(got), n(want), **TOL)


def test_plain_lse_normalises():
    """sum_j exp2(s_j - L) == 1 for every row (exp2-domain scores)."""
    q, k, v, _ = _qkvdo(100, 300, 64, seed=4)
    _, l2 = fb.flash_fwd_lse(t(q), t(k), t(v), SCALE)
    s2 = np.einsum("bqd,bkd->bqk", q, k) * SCALE * 1.4426950408889634
    ones = np.exp2(s2 - n(l2)[..., None]).sum(-1)
    np.testing.assert_allclose(ones, 1.0, atol=1e-5)


def test_plain_bwd_rounds_like_the_kernels_in_bf16():
    """In bf16, P and dS are rounded before their products, as in JAX:
    the plain version agrees with JAX's own bf16 kernels to a bf16 bar."""
    q, k, v, do = _qkvdo(128, 192, 64, seed=5)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do)]
    tb = [t(a).to(torch.bfloat16) for a in (q, k, v, do)]
    jout, jl2 = j_flash_fwd_lse(*jb[:3], SCALE, 64, 64, interpret=True)
    want = j_flash_bwd(*jb[:3], jout, jl2, jb[3], SCALE, block_q=64,
                       block_k=64, interpret=True)
    out, l2 = fb.flash_fwd_lse(*tb[:3], SCALE)
    got = fb.flash_bwd(*tb[:3], out, l2, tb[3], SCALE)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(n(g), n(w), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("lq,lk", [(256, 258), (300, 100)])
def test_chunked_bwd_matches_jax(lq, lk):
    q, k, v, do = _qkvdo(lq, lk, 64, seed=6)
    out = fa.attention_reference(t(q)[None], t(k)[None], t(v)[None],
                                 SCALE)[0]
    want = _chunked_xla_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(n(out)), jnp.asarray(do), SCALE)
    got = fa.chunked_bwd(t(q), t(k), t(v), out, t(do), SCALE)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), **TOL)


@pytest.fixture(scope="module")
def jax_attention_grad():
    """jax.grad of sum(flash_attention(q, k, v) * do), compiled once."""
    def f(q, k, v, do):
        return jnp.sum(j_flash_attention(q, k, v, interpret=True) * do)
    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))


ROUTES = {
    # route: (lq, lk, environment)
    "reference": (200, 258, {}),
    "shortkv": (200, 258, {"PCDMS_SHORTKV": "pallas"}),
    "flash": (300, 520, {}),
    "flash_online_switch": (300, 520, {"PCDMS_FROZEN_MAX": "0",
                                       "PCDMS_EXP_BF16": "1"}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_autograd_matches_jax_grad(route, monkeypatch, jax_attention_grad):
    """Gradients through the port's router on each route equal jax.grad
    through the JAX router; under autograd the kernel routes take the
    differentiable Functions (the flash one ignores the forward-only
    switches, as JAX's training path does)."""
    lq, lk, env = ROUTES[route]
    for name in ("PCDMS_SHORTKV", "PCDMS_FROZEN_MAX", "PCDMS_EXP_BF16"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    q, k, v, do = _arrays([(1, 2, lq, 64), (1, 2, lk, 64), (1, 2, lk, 64),
                           (1, 2, lq, 64)], seed=lq + lk)
    want = jax_attention_grad(*(jnp.asarray(a) for a in (q, k, v, do)))

    calls = []
    for name in ("flash_fwd_lse_plain", "flash_bwd_plain"):
        fn = getattr(fb, name)
        monkeypatch.setattr(fb, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    tq, tk, tv = (t(a).requires_grad_() for a in (q, k, v))
    fa.reset_launches()
    out = fa.flash_attention(tq, tk, tv)
    (out * t(do)).sum().backward()
    assert sum(fa.LAUNCHES.values()) == 0          # CPU: plain versions only
    flash = route.startswith("flash")
    assert calls == (["flash_fwd_lse_plain", "flash_bwd_plain"] if flash
                     else [])
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(n(got), n(w), **TOL)


def test_no_grad_routing_unchanged(monkeypatch):
    """Without autograd the long-kv route stays the frozen-max forward."""
    monkeypatch.delenv("PCDMS_FROZEN_MAX", raising=False)
    q, k, v = (t(a)[None] for a in _arrays(
        [(2, 64, 64), (2, 400, 64), (2, 400, 64)], 9))
    q.requires_grad_()
    with torch.no_grad():
        got = fa.flash_attention(q, k, v)
    want = fa.flash_frozen_plain(q[0].detach(), k[0], v[0],
                                 1.0 / math.sqrt(64))
    torch.testing.assert_close(got[0], want, atol=0, rtol=0)



# ---------------------------------------------------------------------------
# the bf16 kernels' tiling and input checks, as far as the CPU reaches them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,lq,lk", [
    (10, 8192, 8192), (20, 2048, 2048), (40, 512, 512),   # the UNet's levels
    (3, 70, 130), (3, 129, 127), (3, 192, 8200), (2, 1, 64), (1, 64, 1),
    (1, 1, 1)])
def test_bwd_plan_covers_every_row_once(bh, lq, lk):
    """Per kernel, the blocks own every row of their operand exactly once
    and the looped tiles hold every row of the other exactly once."""
    plan = fb.bwd_plan(lq, lk, bh)
    for name, own, looped in (("dq", lq, lk), ("dkv", lk, lq)):
        p = plan[name]
        assert p["grid"][1] == bh
        owned = np.zeros(own, int)
        for i in range(p["grid"][0]):
            owned[i * fb.BLOCK_ROWS:(i + 1) * fb.BLOCK_ROWS] += 1
        assert (owned == 1).all()
        assert (p["grid"][0] - 1) * fb.BLOCK_ROWS < own     # no empty block
        walked = np.zeros(looped, int)
        for j in range(p["tiles"]):
            walked[j * p["tile"]:(j + 1) * p["tile"]] += 1
        assert (walked == 1).all()
        assert (p["tiles"] - 1) * p["tile"] < looped        # no empty tile


def test_bwd_plan_has_the_kernels_constants():
    """The plan's block and tile rows are those the CUDA source compiles."""
    csrc = Path(fb.__file__).resolve().parent / "csrc"
    src = (csrc / "flash_attention_bwd.cu").read_text()
    # the block's shape is shared with the forward kernels
    hopper = (csrc / "hopper.cuh").read_text()
    assert "constexpr int kConsumers = 2;" in hopper
    assert "constexpr int kBlockRows = kConsumers * 64;" in hopper
    assert "using hp::kBlockRows;" in src and "using hp::kConsumers;" in src
    assert fb.BLOCK_ROWS == 2 * 64
    plan = fb.bwd_plan(8192, 8192, 10)
    assert f"kDqTile = {plan['dq']['tile']}," in src
    assert f"kDkvTile = {plan['dkv']['tile']}," in src
    assert plan["dq"]["grid"] == plan["dkv"]["grid"] == (64, 10)


@pytest.mark.parametrize("bh,length,blocks,dq_tiles,dkv_tiles", [
    (10, 8192, 64, 64, 128), (20, 2048, 16, 16, 32), (40, 512, 4, 4, 8)])
def test_bwd_plan_at_the_unet_levels(bh, length, blocks, dq_tiles,
                                     dkv_tiles):
    """Grid and ring trips of both kernels at the UNet's three
    self-attention shapes: 128-row blocks; 128-key stages in dq, 64-row
    stages in dk/dv."""
    plan = fb.bwd_plan(length, length, bh)
    assert plan["dq"] == dict(grid=(blocks, bh), tile=128, tiles=dq_tiles)
    assert plan["dkv"] == dict(grid=(blocks, bh), tile=64, tiles=dkv_tiles)


def _layout_inputs():
    q = torch.zeros((2, 64, 64))
    return q, torch.zeros_like(q), torch.zeros((2, 64)), torch.zeros_like(q)


def test_bwd_layout_check_accepts_what_the_forward_returns():
    fb.check_bwd_layout(*_layout_inputs())


@pytest.mark.parametrize("case", ["do_transposed", "do_misaligned",
                                  "out_strided", "lse2_strided",
                                  "lse2_shape", "lse2_dtype", "do_shape"])
def test_bwd_layout_check_raises(case):
    """``flash_bwd`` hands a CUDA call's ``out``, ``do`` and ``lse2`` to
    ``check_bwd_layout``: contiguous, 16-byte aligned, of q's shape."""
    q, out, lse2, do = _layout_inputs()
    if case == "do_transposed":
        do = do.transpose(1, 2)
    elif case == "do_misaligned":
        do = torch.zeros(do.numel() + 4)[1:1 + do.numel()].view_as(do)
        assert do.is_contiguous() and do.data_ptr() % 16
    elif case == "out_strided":
        out = torch.zeros((2, 64, 128))[..., ::2]
    elif case == "lse2_strided":
        lse2 = torch.zeros((2, 64, 2))[..., 0]
    elif case == "lse2_shape":
        lse2 = lse2[:, :32]
    elif case == "lse2_dtype":
        lse2 = lse2.double()
    else:
        do = do[:, :32]
    with pytest.raises(ValueError):
        fb.check_bwd_layout(q, out, lse2, do)


def test_flash_bwd_checks_cuda_inputs_before_launching():
    """On a CUDA tensor ``flash_bwd`` runs the checks and then the kernels,
    with no route to the plain version."""
    import inspect
    src = inspect.getsource(fb.flash_bwd)
    cuda_part = src.split("return flash_bwd_plain", 1)[1]
    assert "check_bwd_layout(q, out, lse2, do)" in cuda_part
    assert "_check(q, k, v)" in cuda_part
    assert "plain" not in cuda_part and "try" not in cuda_part
    assert cuda_part.index("check_bwd_layout") < cuda_part.index("launch_dq")


def test_bf16_backward_source_is_the_hopper_design():
    """The bf16 dq and dk/dv kernels issue wgmma, fill their ring by TMA
    under mbarriers, and no longer use the warp-level mma."""
    csrc = Path(fb.__file__).resolve().parent / "csrc"
    bwd = (csrc / "flash_attention_bwd.cu").read_text()
    hopper = (csrc / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in bwd
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.",
                   "setmaxnreg", "CU_TENSOR_MAP_SWIZZLE_128B"):
        assert needle in hopper, needle
    for call in ("hp::wgmma_ss(", "hp::wgmma_rs(", "hp::tma_load_rows(",
                 "hp::mbar_wait(", "hp::reg_alloc<"):
        assert call in bwd, call
    for gone in ("mma.sync", "mma_bf16(", "mma_abt(", "mma_ab(",
                 "load_tile_bf16(", "getenv"):
        assert gone not in bwd, gone
