"""The evaluation protocol's modules (``pcdms_tpu_torch/eval/metrics.py``,
``eval/inception.py``, ``eval/lpips.py``) against the JAX package's, on the
CPU in f32, from inputs made with numpy from a seed.

* Host metrics: ``compare_psnr`` / ``compare_l1`` / ``compare_mae`` /
  ``compare_ssim`` (both protocol variants), ``frechet_distance`` (also on
  singular covariances, through the eps-offset retry), ``get_image_list``
  and ``preprocess_path_for_deform_task`` are the same numpy and scipy code:
  equal exactly. ``FID.activation_statistics`` on one feature function:
  equal, the ragged tail dropped on both sides.
* ``_load_resized`` (PyTorch bicubic here, ``cv2.resize(INTER_CUBIC)`` in
  the JAX package) within 1e-4 in [0, 1] units at both protocol sizes, from
  sources that are downsampled, upsampled and kept.
* ``ReconstructionMetrics.calculate_from_disk`` within 1e-4 on a small
  directory; its ``*_metrics.npz`` and FID's ``*_statistics.npz`` caches
  written by either package are read by the other (same keys and dtypes).
* InceptionV3 pool3 against ``inception_pool3`` at batch 2 from 256x176 and
  512x352 images (an upsample and a downsample to 299: the resize
  antialiases on both sides), features within rel L2 1e-4, with the weights
  carried both ways: one seeded pt_inception state dict into
  ``convert_inception`` and ``fold_state_dict``, and the JAX tree through
  ``compat/from_jax.py::inception_from_jax``.
* LPIPS-Alex against ``lpips_distance`` at both sizes, within rel 1e-5,
  through ``convert_lpips`` in both namings and ``lpips_from_jax``;
  identical images give 0.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pcdms_tpu.eval import inception as j_inception
from pcdms_tpu.eval import lpips as j_lpips
from pcdms_tpu.eval import metrics as jm

from pcdms_tpu_torch.compat.from_jax import inception_from_jax, lpips_from_jax
from pcdms_tpu_torch.eval import inception, lpips
from pcdms_tpu_torch.eval import metrics as tm

from _torch_common import one_thread

# (H, W) of the two protocols' images: --resolution 256 and 512
SIZES = [(256, 176), (512, 352)]
RESIZE_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def inception_sd(seed=0):
    """A seeded pt_inception-layout state dict (conv + BatchNorm per unit)
    at full geometry, as numpy."""
    rng = np.random.default_rng(seed)
    sd = {}
    for prefix, (cin, cout, k, _, _) in inception.UNITS.items():
        fan_in = cin * k[0] * k[1]
        # He scaling: the features keep a spread through the 94 ReLUs
        sd[f"{prefix}.conv.weight"] = (rng.standard_normal(
            (cout, cin) + k, dtype=np.float32) * np.sqrt(2.0 / fan_in)
        ).astype(np.float32)
        sd[f"{prefix}.bn.weight"] = rng.uniform(0.5, 1.5, cout).astype(
            np.float32)
        sd[f"{prefix}.bn.bias"] = (0.1 * rng.standard_normal(cout)).astype(
            np.float32)
        sd[f"{prefix}.bn.running_mean"] = (
            0.1 * rng.standard_normal(cout)).astype(np.float32)
        sd[f"{prefix}.bn.running_var"] = rng.uniform(0.5, 1.5, cout).astype(
            np.float32)
    return sd


def lpips_sd(seed=1, naming="features"):
    """A seeded lpips (alex) state dict, as numpy, in either naming."""
    rng = np.random.default_rng(seed)
    sd = {}
    for i, ((cin, cout, k, _, _), fi, si) in enumerate(zip(
            lpips.ALEX, lpips.FEATURE_INDEX, lpips.SLICE_INDEX)):
        name = (f"net.features.{fi}" if naming == "features"
                else f"net.slice{si}.{fi}")
        sd[f"{name}.weight"] = (rng.standard_normal(
            (cout, cin, k, k), dtype=np.float32) / np.sqrt(cin * k * k)
        ).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.standard_normal(cout)).astype(
            np.float32)
        lin = (f"lin{i}.model.1.weight" if naming == "features"
               else f"lins.{i}.model.1.weight")
        sd[lin] = rng.uniform(0, 1, (1, cout, 1, 1)).astype(np.float32)
    return sd


def _torch_sd(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------- metrics --

def _pair(seed, shape=(40, 36, 3)):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, shape).astype(np.float32)
    pred = np.clip(gt + 0.1 * rng.standard_normal(shape), 0, 1).astype(
        np.float32)
    return gt, pred


@pytest.mark.parametrize("seed", [0, 1])
def test_pixel_metrics_equal_jax(seed):
    gt, pred = _pair(seed)
    assert tm.compare_psnr(gt, pred) == jm.compare_psnr(gt, pred)
    assert tm.compare_psnr(gt, gt) == jm.compare_psnr(gt, gt) == float("inf")
    assert tm.compare_l1(gt, pred) == jm.compare_l1(gt, pred)
    assert tm.compare_mae(gt, pred) == jm.compare_mae(gt, pred)
    rec_t = tm.ReconstructionMetrics(win_size=7).compute_pair(gt, pred)
    rec_j = jm.ReconstructionMetrics(win_size=7).compute_pair(gt, pred)
    assert rec_t == rec_j
    # ssim_256: gaussian sigma 1.2, population covariance, 0-255 images
    g, p = gt * 255.0, pred * 255.0
    kw = dict(data_range=float(p.max() - p.min()), gaussian_weights=True,
              sigma=1.2, use_sample_covariance=False)
    assert tm.compare_ssim(g, p, **kw) == jm.compare_ssim(g, p, **kw)


def test_frechet_distance_equal_jax():
    rng = np.random.default_rng(2)
    feats = [rng.standard_normal((n, 16)) @ rng.standard_normal((16, 16))
             for n in (40, 50)]
    stats = [(f.mean(0), np.cov(f, rowvar=False)) for f in feats]
    want = jm.frechet_distance(*stats[0], *stats[1])
    assert tm.frechet_distance(*stats[0], *stats[1]) == want
    # fewer samples than dimensions: singular covariances, eps retry
    few = [rng.standard_normal((3, 16)) for _ in range(2)]
    stats = [(f.mean(0), np.cov(f, rowvar=False)) for f in few]
    want = jm.frechet_distance(*stats[0], *stats[1])
    got = tm.frechet_distance(*stats[0], *stats[1])
    assert np.isfinite(got) and got == want


def test_activation_statistics_drop_the_ragged_tail():
    proj = np.random.default_rng(3).standard_normal((12, 8)).astype(
        np.float32)

    def feature_fn(images):
        return images.reshape(len(images), -1) @ proj

    images = np.random.default_rng(4).uniform(
        0, 1, (11, 2, 2, 3)).astype(np.float32)
    mu_t, sigma_t = tm.FID(feature_fn, batch_size=4).activation_statistics(
        images)
    mu_j, sigma_j = jm.FID(feature_fn, batch_size=4).activation_statistics(
        images)
    np.testing.assert_array_equal(mu_t, mu_j)
    np.testing.assert_array_equal(sigma_t, sigma_j)
    assert mu_t.dtype == mu_j.dtype and sigma_t.dtype == sigma_j.dtype
    np.testing.assert_allclose(mu_t, feature_fn(images[:8]).mean(0),
                               rtol=1e-6)
    # a feature function that returns a tensor (the port's) works the same
    mu_x, _ = tm.FID(lambda x: torch.from_numpy(feature_fn(x)),
                     batch_size=4).activation_statistics(images)
    np.testing.assert_array_equal(mu_x, mu_t)


def _write(path, arr):
    Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def pair_dirs(tmp_path_factory):
    """GT and generated dirs in the '_to_' naming (one generated file has
    no GT and one is a .jpg name), at a size that both protocols
    upsample."""
    root = tmp_path_factory.mktemp("pairs")
    gt, gen = root / "gt", root / "gen"
    gt.mkdir()
    gen.mkdir()
    rng = np.random.default_rng(5)
    for i in range(3):
        arr = rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
        _write(gt / f"t{i}.png", arr)
        noisy = np.clip(arr + rng.integers(-25, 25, arr.shape), 0, 255)
        _write(gen / f"gs{i}_to_t{i}.png", noisy.astype(np.uint8))
    arr = rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
    _write(gt / "t3.png", arr)
    _write(gen / "gs3_to_t3.jpg", arr[::-1])
    _write(gen / "gs9_to_missing.png", np.zeros((64, 48, 3), np.uint8))
    return gt, gen


def test_pairing_and_image_lists_equal_jax(pair_dirs, tmp_path):
    gt, gen = pair_dirs
    assert tm.get_image_list(str(gen)) == jm.get_image_list(str(gen))
    assert tm.get_image_list(["b", "a"]) == ["b", "a"]
    one = str(gt / "t0.png")
    assert tm.get_image_list(one) == jm.get_image_list(one) == [one]
    assert tm.get_image_list(str(tmp_path / "none")) == []
    got = tm.preprocess_path_for_deform_task(str(gt), str(gen))
    assert got == jm.preprocess_path_for_deform_task(str(gt), str(gen))
    assert [os.path.basename(p) for p in got[0]] == ["t0.png", "t1.png",
                                                     "t2.png", "t3.png"]


@pytest.mark.parametrize("src_hw", [(1024, 512), (512, 512), (256, 176),
                                    (64, 64), (96, 72)])
def test_load_resized_within_tolerance_of_cv2(src_hw, tmp_path):
    arr = np.random.default_rng(src_hw[0] + src_hw[1]).integers(
        0, 256, src_hw + (3,), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    _write(path, arr)
    for h, w in SIZES:
        got = tm._load_resized(path, (w, h))
        want = jm._load_resized(path, (w, h))
        assert got.shape == want.shape == (h, w, 3)
        assert got.dtype == want.dtype == np.float32
        assert np.abs(got - want).max() <= RESIZE_TOL


def test_reconstruction_from_disk_and_caches(pair_dirs, tmp_path):
    gt, gen = pair_dirs
    gt_list, kept = tm.preprocess_path_for_deform_task(str(gt), str(gen))
    size = (176, 256)
    got = tm.ReconstructionMetrics().calculate_from_disk(
        kept, gt_list, save_path=str(tmp_path), img_size=size, sort=False)
    want = jm.ReconstructionMetrics().calculate_from_disk(
        kept, gt_list, save_path=None, img_size=size, sort=False)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    # the port's per-pair cache is the JAX package's: same name, keys, dtype
    cache = tmp_path / "176_256_metrics.npz"
    with np.load(cache) as f:
        assert sorted(f.files) == sorted(tm._KEYS)
        assert all(f[k].dtype == np.float64 and f[k].shape == (4,)
                   for k in f.files)
    assert jm.ReconstructionMetrics().calculate_from_disk(
        [], [], save_path=str(tmp_path), img_size=size) == got
    # and the JAX package's cache is read by the port
    jdir = tmp_path / "j"
    jdir.mkdir()
    want = jm.ReconstructionMetrics().calculate_from_disk(
        kept, gt_list, save_path=str(jdir), img_size=size, sort=False)
    assert tm.ReconstructionMetrics().calculate_from_disk(
        [], [], save_path=str(jdir), img_size=size) == want
    with pytest.raises(ValueError, match="no generated/GT image pairs"):
        tm.ReconstructionMetrics().calculate_from_disk([], [])


def test_fid_statistics_cache_interchangeable(pair_dirs, tmp_path):
    _, gen = pair_dirs
    proj = np.random.default_rng(6).standard_normal(
        (176 * 256 * 3, 8)).astype(np.float32)

    def feature_fn(images):
        return images.reshape(len(images), -1) @ proj

    stats = tmp_path / "176_256_statistics.npz"
    for img in sorted(os.listdir(gen)):
        os.link(gen / img, tmp_path / img)
    mu, sigma = tm.FID(feature_fn).compute_statistics_of_path(
        str(tmp_path), (176, 256))
    with np.load(stats) as f:
        assert sorted(f.files) == ["mu", "sigma"]
        assert f["mu"].dtype == np.float32 and f["sigma"].dtype == np.float64
    # the JAX package reads the port's cache (its feature_fn is not called)
    j_mu, j_sigma = jm.FID(None).compute_statistics_of_path(
        str(tmp_path), (176, 256))
    np.testing.assert_array_equal(j_mu, mu)
    np.testing.assert_array_equal(j_sigma, sigma)
    # and the port reads the JAX package's
    os.remove(stats)
    j_mu, j_sigma = jm.FID(feature_fn).compute_statistics_of_path(
        str(tmp_path), (176, 256))
    np.testing.assert_allclose(j_mu, mu, rtol=1e-3, atol=1e-3)
    t_mu, t_sigma = tm.FID(None).compute_statistics_of_path(
        str(tmp_path), (176, 256))
    np.testing.assert_array_equal(t_mu, j_mu)
    np.testing.assert_array_equal(t_sigma, j_sigma)


# --------------------------------------------------------------- networks --

@pytest.fixture(scope="module")
def inception_pair():
    """(JAX params, port module from the torch state dict, port module from
    the JAX tree)."""
    sd = inception_sd()
    params = j_inception.convert_inception(sd)
    folded = inception.InceptionV3()
    folded.load_state_dict(inception.fold_state_dict(_torch_sd(sd)))
    return params, folded.eval(), inception_from_jax(
        jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_inception_pool3_matches_jax(inception_pair, hw):
    params, folded, carried = inception_pair
    images = np.random.default_rng(hw[0]).uniform(
        0, 1, (2,) + hw + (3,)).astype(np.float32)
    want = np.asarray(jax.jit(j_inception.inception_pool3)(
        params, jnp.asarray(images)))
    with torch.no_grad():
        for model in (folded, carried):
            got = model(torch.from_numpy(images)).numpy()
            assert got.shape == want.shape == (2, 2048)
            assert _rel_l2(got, want) <= 1e-4


def test_inception_weight_routes_agree(inception_pair):
    _, folded, carried = inception_pair
    a, b = folded.state_dict(), carried.state_dict()
    assert set(a) == set(b) and len(a) == 2 * len(inception.UNITS)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_inception_feature_fn_from_file(tmp_path):
    """``make_inception_feature_fn`` reads the published layout from a
    file (torchvision's extra ``fc`` / ``AuxLogits`` keys unread) and
    returns f32 features on the device it was given."""
    sd = _torch_sd(inception_sd(seed=3))
    sd["fc.weight"] = torch.zeros(1000, 2048)
    path = str(tmp_path / "pt_inception.pth")
    torch.save(sd, path)
    fn = inception.make_inception_feature_fn(path, device="cpu")
    images = np.random.default_rng(7).uniform(
        0, 1, (1, 64, 48, 3)).astype(np.float32)
    got = fn(images)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    model = inception.InceptionV3()
    model.load_state_dict(inception.fold_state_dict(sd))
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(images))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.fixture(scope="module")
def lpips_pair():
    sd = lpips_sd()
    params = j_lpips.convert_lpips(sd)
    model = lpips.LPIPS()
    model.load_state_dict(lpips.convert_lpips(_torch_sd(sd)))
    return params, model.eval(), lpips_from_jax(
        jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_lpips_matches_jax(lpips_pair, hw):
    params, model, carried = lpips_pair
    rng = np.random.default_rng(hw[1])
    a, b = (rng.uniform(0, 1, (2,) + hw + (3,)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jax.jit(j_lpips.lpips_distance)(
        params, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        for m in (model, carried):
            got = m(torch.from_numpy(a), torch.from_numpy(b)).numpy()
            assert got.shape == (2,)
            np.testing.assert_allclose(got, want, rtol=1e-5)
        same = model(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    assert np.all(same == 0.0)


def test_lpips_namings_and_missing_keys():
    a = lpips.convert_lpips(_torch_sd(lpips_sd(naming="features")))
    b = lpips.convert_lpips(_torch_sd(lpips_sd(naming="slices")))
    assert set(a) == set(b) == set(lpips.LPIPS().state_dict())
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    sd = _torch_sd(lpips_sd())
    del sd["lin2.model.1.weight"]
    with pytest.raises(KeyError, match="lin2"):
        lpips.convert_lpips(sd)
    with pytest.raises(KeyError):
        j_lpips.convert_lpips({k: v.numpy() for k, v in sd.items()})


def test_lpips_from_disk_matches_jax(pair_dirs, tmp_path):
    """Batches of 3 over 4 pairs: the ragged fourth pair is dropped on both
    sides."""
    gt, gen = pair_dirs
    path = str(tmp_path / "alex.pth")
    torch.save(_torch_sd(lpips_sd(seed=4)), path)
    gt_list, kept = tm.preprocess_path_for_deform_task(str(gt), str(gen))
    got = lpips.lpips_from_disk(path, kept, gt_list, (176, 256),
                                batch_size=3, device="cpu")
    want = j_lpips.lpips_from_disk(path, kept, gt_list, (176, 256),
                                   batch_size=3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    only_three = lpips.lpips_from_disk(path, kept[:3], gt_list[:3],
                                       (176, 256), batch_size=3,
                                       device="cpu")
    assert got == only_three
