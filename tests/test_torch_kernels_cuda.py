"""The CUDA flash-attention kernels against their plain PyTorch versions,
on a card only (marker ``cuda``; they skip without one, since a CUDA kernel
has no CPU form). JAX-free, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Bars: f32 max abs error 2e-5; bf16 (and the bf16-softmax variant) max abs
error 1e-2 of the output's largest magnitude, which admits the one bf16 ulp
(at most 2^-7 of a value) by which two accumulation orders may round apart.
"""

import math

import pytest
import torch

from pcdms_tpu_torch.ops import flash_attention as fa

D = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, dtype, bh, lq, lk, seed=11):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((bh, n, D), generator=gen, device=dev).to(dtype)
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


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(300, 600), (128, 128), (64, 1)])
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
