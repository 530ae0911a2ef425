"""``pcdms_tpu_torch/cli/calculate_metrics.py`` against the JAX package's
``cli/calculate_metrics.py``, on the CPU, on the same directories and the
same weight files (seeded full-geometry pt_inception and lpips-alex state
dicts saved with ``torch.save``), at ``--resolution 256`` and ``512``.

Each CLI writes its caches into the directories it scores, so each runs on
its own copy. Bars: every scalar of the results line but ``fid`` within
1e-4 (the images are resized by PyTorch's bicubic on one side and cv2's on
the other, 4e-5 apart); the ``{W}_{H}_statistics.npz`` files within rel
1e-4 (mu) and rel L2 1e-4 (sigma), same dtypes. Without weights FID and
LPIPS are skipped with the JAX CLI's notices, and a second run appends its
line and reads the other package's caches.

``scipy.linalg.sqrtm`` of a 2048x2048 matrix takes over a minute on this
CPU, so the tier-1 tests run both CLIs with the same stand-in for it (a
zero matrix): ``fid`` then is |mu1 - mu2|^2 + tr(sigma1) + tr(sigma2) of
each side's own statistics, held at rel 1e-4. ``frechet_distance`` itself, with
the real sqrtm and its eps-offset retry, equals the JAX function exactly in
``test_torch_eval.py``. The slow test runs both CLIs with the real sqrtm:
with 4 images per directory the covariances are singular, and ``fid`` from
each side's own statistics is held at rel 1e-5 (measured on the CPU: 3.2e-9
at 256, 3.0e-7 at 512).
"""

import logging
import shutil

import numpy as np
import pytest
import scipy.linalg
import torch
from PIL import Image

from pcdms_tpu.cli import calculate_metrics as j_cli
from pcdms_tpu.eval.metrics import frechet_distance as j_frechet

from pcdms_tpu_torch.cli import calculate_metrics as t_cli
from pcdms_tpu_torch.eval.metrics import frechet_distance

from _torch_common import one_thread
from test_torch_eval import inception_sd, lpips_sd

TARGETS = ["ta.png", "tb.png", "tc.png", "td.png"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("metrics_cli")
    gt, gen, train = root / "gt", root / "gen", root / "train"
    for d in (gt, gen, train):
        d.mkdir()
    rng = np.random.default_rng(0)

    def image():
        # a brightness and contrast of its own: the images' features differ
        # by more than the two resizes do
        level, spread = rng.uniform(40, 215), rng.uniform(10, 40)
        return np.clip(level + spread * rng.standard_normal((96, 72, 3)), 0,
                       255).astype(np.uint8)

    for i, t in enumerate(TARGETS):
        arr = image()
        Image.fromarray(arr).save(gt / t)
        noisy = np.clip(arr.astype(np.int16)
                        + rng.integers(-20, 20, arr.shape), 0, 255)
        Image.fromarray(noisy.astype(np.uint8)).save(gen / f"gs{i}_to_{t}")
        Image.fromarray(image()).save(train / f"train{i}.png")
    wdir = root / "weights"
    wdir.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in inception_sd(1).items()},
               wdir / "pt_inception.pth")
    torch.save({k: torch.from_numpy(v) for k, v in lpips_sd(2).items()},
               wdir / "alex.pth")
    return root


def _zero_sqrtm(a, *args, **kwargs):
    return np.zeros_like(a)


@pytest.fixture
def fast_sqrtm(monkeypatch):
    """Both packages call ``scipy.linalg.sqrtm``: one stand-in for both."""
    monkeypatch.setattr(scipy.linalg, "sqrtm", _zero_sqrtm)


def _copy(world, name):
    dst = world / name
    for d in ("gt", "gen", "train"):
        shutil.copytree(world / d, dst / d)
    return dst


def _argv(root, world, resolution, save, weights=True):
    argv = ["--fid_real_path", str(root / "train"),
            "--test_path", str(root / "gt"),
            "--generated_path", str(root / "gen"),
            "--resolution", str(resolution), "--save_name", str(save)]
    if weights:
        argv += ["--inception_weights", str(world / "weights" /
                                            "pt_inception.pth"),
                 "--lpips_weights", str(world / "weights" / "alex.pth")]
    return argv


def _line(save):
    with open(f"{save}_results.txt") as f:
        lines = f.read().strip().splitlines()
    path, rec = lines[-1].split(" ", 1)
    return len(lines), path, eval(rec)     # noqa: S307 (a dict literal)


def _compare(world, resolution, flag, fid_rtol, tag):
    jroot, troot = (_copy(world, f"{side}{resolution}{tag}")
                    for side in ("j", "t"))
    j_cli.main(_argv(jroot, world, resolution, jroot / "m"))
    got = t_cli.main(_argv(troot, world, resolution, troot / "m") +
                     ["--device", "cpu"])
    _, jpath, want = _line(jroot / "m")
    n, tpath, line = _line(troot / "m")
    assert n == 1 and tpath == str(troot / "gen") and line == got
    assert set(got) == set(want) == {
        "fid", "lpips", "psnr", "ssim", "ssim_256", "mae", "l1",
        "psnr_variance", "ssim_variance", "ssim_256_variance",
        "mae_variance", "l1_variance"}
    for k in want:
        if k != "fid":
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    stats = {}
    for d in ("train", "gen"):
        with np.load(jroot / d / f"{flag}_statistics.npz") as fj, \
                np.load(troot / d / f"{flag}_statistics.npz") as ft:
            assert ft["mu"].dtype == fj["mu"].dtype
            assert ft["sigma"].dtype == fj["sigma"].dtype
            np.testing.assert_allclose(ft["mu"], fj["mu"], rtol=1e-4,
                                       atol=1e-6)
            assert (np.linalg.norm(ft["sigma"] - fj["sigma"])
                    <= 1e-4 * np.linalg.norm(fj["sigma"]))
            stats[d] = (ft["mu"][:], ft["sigma"][:])
    assert (jroot / "gen" / f"{flag}_metrics.npz").exists()
    assert (troot / "gen" / f"{flag}_metrics.npz").exists()
    assert got["fid"] >= 0 and np.isfinite(got["fid"])
    np.testing.assert_allclose(got["fid"], want["fid"], rtol=fid_rtol)
    same = (*stats["train"], *stats["gen"])
    assert frechet_distance(*same) == j_frechet(*same) == got["fid"]
    return got["fid"], want["fid"]


@pytest.mark.parametrize("resolution,flag", [(256, "176_256"),
                                             (512, "352_512")])
def test_cli_matches_jax(world, fast_sqrtm, resolution, flag):
    _compare(world, resolution, flag, 1e-4, "")


@pytest.mark.slow
@pytest.mark.parametrize("resolution,flag", [(256, "176_256"),
                                             (512, "352_512")])
def test_cli_matches_jax_real_sqrtm(world, resolution, flag):
    got, want = _compare(world, resolution, flag, 1e-5, "real")
    print(f"fid at {resolution}: port {got!r}, JAX {want!r}, rel "
          f"{abs(got - want) / abs(want):.3e}")


def test_cli_reads_jax_caches_and_appends(world, fast_sqrtm):
    """The port's second run on the JAX run's directories reads the JAX
    caches (the raw train images are gone) and appends its line."""
    root = _copy(world, "cache")
    j_cli.main(_argv(root, world, 256, root / "m"))
    _, _, want = _line(root / "m")
    for f in (root / "train").glob("*.png"):
        f.unlink()
    got = t_cli.main(_argv(root, world, 256, root / "m") +
                     ["--device", "cpu"])
    n, _, line = _line(root / "m")
    assert n == 2 and line == got
    assert got["fid"] == want["fid"]
    for k in ("ssim", "psnr", "l1", "mae", "ssim_256"):
        assert got[k] == want[k]


def test_cli_skips_without_weights(world, caplog):
    root = _copy(world, "noweights")
    with caplog.at_level(logging.WARNING, "pcdms_tpu_torch.metrics"):
        got = t_cli.main(_argv(root, world, 256, root / "m", weights=False)
                         + ["--device", "cpu"])
    msgs = " ".join(r.getMessage() for r in caplog.records)
    assert "skipping FID" in msgs and "skipping LPIPS" in msgs
    _, _, line = _line(root / "m")
    assert "fid" not in line and "lpips" not in line and line == got
    assert 0 < got["ssim"] <= 1
    assert not (root / "train" / "176_256_statistics.npz").exists()
