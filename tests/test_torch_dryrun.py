"""``parallel/dryrun.py``: ``dryrun_multichip(2)`` (one tiny stage-2 ZeRO-1
step over a ``gloo`` world of 2 CPU processes, each rank against the world-1
step) and ``entry()``'s full-width stage-2 UNet and inputs, built on the
``meta`` device (no memory; its kernels run on the card only)."""

import pytest
import torch

from pcdms_tpu_torch.parallel.dryrun import dryrun_multichip, entry

from _torch_common import one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def test_dryrun_multichip_two_ranks(tmp_path, capsys):
    dryrun_multichip(2, workdir=str(tmp_path))
    assert "dryrun_multichip(2): flat (1 slice(s)) ok" in capsys.readouterr(
    ).out


def test_entry_is_the_full_width_stage2_unet():
    fn, args = entry("meta")
    unet, sample = args[0], args[1]
    assert sample.shape == (1, 64, 128, 9) and sample.dtype == torch.bfloat16
    assert unet.cfg.block_out_channels == (320, 640, 1280, 1280)
    assert unet.cfg.in_channels == 9 and unet.cfg.class_embed_proj_dim
    assert {p.dtype for p in unet.parameters()} == {torch.bfloat16}
    assert [a.shape[0] for a in args[1:]] == [1] * 5
    assert callable(fn)
