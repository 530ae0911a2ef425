"""The port's flash attention against the JAX package's.

On the CPU: the plain versions of the three CUDA kernels against the Pallas
kernels in interpret mode (as tests/test_flash_attention.py runs them), the
router's decisions, and the wrappers' refusal to run a kernel on a CPU
tensor. The kernels themselves are held against the plain versions on a
card by tests/test_torch_kernels_cuda.py. Bars: f32 2e-5, bf16 3e-2, the
bf16-softmax variant 2e-2.
"""

import math

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
@pytest.mark.parametrize("lk", [258, 100])
def test_plain_shortkv_matches_pallas(lk, dtype):
    scale = 1.0 / math.sqrt(D)
    (jq, jk, jv), (tq, tk, tv) = _cast(_qkv(300, lk, lk), dtype)
    want = _shortkv_attention_3d(jq, jk, jv, scale, 128, True)
    _assert_close(fa.shortkv_plain(tq, tk, tv, scale), want, BARS[dtype])


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
