"""The depth, normal and line annotator families, part one: the image
operations they add to ``pcdms_tpu_torch/pose/imgproc.py`` against OpenCV
5.0, the seven networks (``pose/detectors/{lineart_anime,mlsd,midas,
normalbae,zoe,leres,leres_boost}.py``) at full width against the JAX
``*_apply``, ``compat/from_jax.py``'s carry-back, and the host protocols
(M-LSD's decode, the LeReS++ boost) against the JAX package, on the CPU.

Bars:
* uint8 bicubic resize: within 1 level of cv2 on at most 1e-3 of each
  case's values and 1e-4 of all of them (cv2 5.0 sums bicubic uint8 in
  f32; the values off lie within an f32 rounding of a half). f64 bicubic
  equal, f64 bilinear within 1e-13 x max |cv2|; Sobel on f64 equal, on f32
  within 1e-6 x max |cv2|; integral, convertScaleAbs (every uint16),
  THRESH_TOZERO, bitwise_not, dilate on f64 and the thickness-1 line equal;
  the f32 blur at 73 - 749 taps and the boost's mask within 2e-6 x max;
  INTER_AREA / INTER_LINEAR / INTER_CUBIC on f32 at ZoeDepth's shapes
  within 2e-6 x max.
* The networks at full width on small inputs against the JAX ``*_apply``
  on the trees the JAX ``convert_*`` make from the port's seeded
  ``state_dict()`` (BatchNorm statistics random): atol / rtol 5e-4 (f32);
  ``*_from_jax`` carries each tree back to the port's own folded weights
  exactly.
* ``decode_lines``, ``resizewithpool``, ``calculateprocessingres``,
  ``generatepatchs``, ``generatemask`` and ``estimateboost`` (stub
  estimator and merge) against the JAX functions: the same decisions; the
  boost's map within 2e-4 (a uint8 bicubic pixel a level off cv2's moves
  the stub estimate by up to 1.6e-3 before its resizes).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from pcdms_tpu.pose.detectors import leres as j_leres  # noqa: E402
from pcdms_tpu.pose.detectors import leres_boost as j_boost  # noqa: E402
from pcdms_tpu.pose.detectors import lineart_anime as j_anime  # noqa: E402
from pcdms_tpu.pose.detectors import midas as j_midas  # noqa: E402
from pcdms_tpu.pose.detectors import mlsd as j_mlsd  # noqa: E402
from pcdms_tpu.pose.detectors import normalbae as j_nb  # noqa: E402
from pcdms_tpu.pose.detectors import zoe as j_zoe  # noqa: E402

from pcdms_tpu_torch.compat import from_jax  # noqa: E402
from pcdms_tpu_torch.pose import imgproc  # noqa: E402
from pcdms_tpu_torch.pose.detectors import leres, leres_boost  # noqa: E402
from pcdms_tpu_torch.pose.detectors import lineart_anime, midas  # noqa
from pcdms_tpu_torch.pose.detectors import mlsd, normalbae, zoe  # noqa
from pcdms_tpu_torch.pose.raster import line_pixels  # noqa: E402

from _torch_common import one_thread  # noqa: E402

F32_BAR = 2e-6
NET_TOL = dict(atol=5e-4, rtol=5e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _smooth(h, w, seed, cells=8):
    """A smooth seeded uint8 RGB image (a coarse colour field enlarged)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (max(1, h // cells), max(1, w // cells), 3),
                        dtype=np.uint8)
    return cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)


# ---------------------------------------------------------------------------
# imgproc against cv2
# ---------------------------------------------------------------------------

CUBIC_CASES = [((64, 64), (256, 256)), ((48, 64), (256, 256)),
               ((190, 257), (512, 512)), ((57, 33), (20, 91)),
               ((131, 77), (45, 33)), ((65, 90), (128, 192)),
               ((300, 200), (100, 77)), ((96, 80), (1501, 1251))]


def test_resize_cubic_uint8_within_a_level_of_cv2():
    """The LineArt-Anime feed (to the 256 grid) and the boost's image
    resizes: cv2 5.0 computes uint8 bicubic in f32; the port sums the same
    f32 taps in the same order and rounds half to even."""
    rng = np.random.default_rng(0)
    off = total = 0
    for (sh, sw), (dh, dw) in CUBIC_CASES:
        for c in (1, 3):
            img = rng.integers(0, 256, (sh, sw, c), dtype=np.uint8)
            img = img[..., 0] if c == 1 else img
            want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_CUBIC)
            got = imgproc.resize(t(img), (dw, dh), "cubic").numpy()
            assert got.shape == want.shape and got.dtype == np.uint8
            d = np.abs(got.astype(np.int32) - want)
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (
                (sh, sw), (dh, dw), c, d.max(), (d > 0).mean())
            off, total = off + int((d > 0).sum()), total + d.size
    assert off <= 1e-4 * total, (off, total)


F64_CASES = [((37, 53), (64, 64)), ((100, 170), (64, 128)),
             ((128, 128), (64, 64)), ((131, 77), (45, 33)),
             ((64, 64), (512, 512)), ((57, 33), (20, 91)),
             ((300, 200), (100, 77)), ((90, 70), (50, 50))]


@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_resize_f64_against_cv2(kind):
    flag = {"linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC}[kind]
    rng = np.random.default_rng(1)
    for (sh, sw), (dh, dw) in F64_CASES:
        x = rng.standard_normal((sh, sw)) * 30
        want = cv2.resize(x, (dw, dh), interpolation=flag)
        got = imgproc.resize(t(x), (dw, dh), kind).numpy()
        assert got.dtype == np.float64
        if kind == "cubic":
            np.testing.assert_array_equal(got, want)
        else:
            assert _rel(got, want) <= 1e-13, ((sh, sw), (dh, dw))


def test_boost_flag_as_dst_quirk_is_bilinear():
    """``cv2.resize(grad, (d, d), cv2.INTER_AREA)`` and ``..., cv2.
    INTER_NEAREST)`` (leres_boost.py:179, 195) pass the flag as ``dst``:
    cv2 runs INTER_LINEAR, and so does the port."""
    rng = np.random.default_rng(2)
    for (sh, sw), d in (((90, 70), 50), ((64, 80), 64), ((30, 30), 14)):
        x = rng.standard_normal((sh, sw)) * 5
        for flag in (cv2.INTER_AREA, cv2.INTER_NEAREST):
            want = cv2.resize(x, (d, d), flag)
            np.testing.assert_array_equal(
                want, cv2.resize(x, (d, d), interpolation=cv2.INTER_LINEAR))
            assert _rel(imgproc.resize(t(x), (d, d), "linear").numpy(),
                        want) <= 1e-13


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sobel_against_cv2(dtype):
    rng = np.random.default_rng(3)
    depth = cv2.CV_32F if dtype == np.float32 else cv2.CV_64F
    for h, w in ((37, 53), (64, 64), (5, 9), (128, 96)):
        x = (rng.standard_normal((h, w)) * 10).astype(dtype)
        for dx, dy in ((1, 0), (0, 1)):
            want = cv2.Sobel(x, depth, dx, dy, ksize=3)
            got = imgproc.sobel(t(x), dx, dy).numpy()
            assert got.dtype == want.dtype
            if dtype == np.float64:
                np.testing.assert_array_equal(got, want)
            else:
                assert _rel(got, want) <= 1e-6


def test_integral_against_cv2():
    rng = np.random.default_rng(4)
    for h, w in ((37, 53), (1, 7), (96, 128)):
        x = rng.uniform(0, 300, (h, w))
        np.testing.assert_array_equal(imgproc.integral(t(x)).numpy(),
                                      cv2.integral(x))


def test_uint8_steps_of_leres_against_cv2():
    """convertScaleAbs on every uint16 value at 255 / 65535, THRESH_TOZERO
    at fractional thresholds (cv2 floors them on 8-bit images),
    bitwise_not."""
    x = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    want = cv2.convertScaleAbs(x, alpha=255.0 / 65535.0)
    got = imgproc.convert_scale_abs(t(x.astype(np.int32)), 255.0 / 65535.0)
    np.testing.assert_array_equal(got.numpy(), want)
    u = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for thr in (0.0, 12.75, 25.5, 127.5, 200.0, 254.99, 255.0, -3.0):
        np.testing.assert_array_equal(
            imgproc.threshold_tozero(t(u), thr).numpy(),
            cv2.threshold(u, thr, 255, cv2.THRESH_TOZERO)[1])
    np.testing.assert_array_equal(imgproc.bitwise_not(t(u)).numpy(),
                                  cv2.bitwise_not(u))


@pytest.mark.parametrize("sigma,ksize", [(18, 73), (37, 149), (5, 0)])
def test_gaussian_blur_f32_large_kernels_against_cv2(sigma, ksize):
    rng = np.random.default_rng(5)
    x = rng.random((200, 150, 3)).astype(np.float32)
    want = cv2.GaussianBlur(x, (ksize, ksize), sigma)
    assert _rel(imgproc.gaussian_blur(t(x), sigma, ksize).numpy(),
                want) <= F32_BAR


@pytest.mark.parametrize("n", [300, 600, 3000])
def test_generatemask_equals_jax(n):
    """The boost's blend mask, 3000 x 3000 at sigma 187 over 749 taps as
    the protocol makes it (the port's FFT path, about 2 s on one CPU
    thread)."""
    got = leres_boost.generatemask((n, n)).numpy()
    want = j_boost.generatemask((n, n))
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= F32_BAR * np.abs(want).max()


def test_resize_f32_at_zoe_shapes_against_cv2():
    """ZoeDepth's way in (INTER_AREA where the padded image shrinks to its
    net size, INTER_LINEAR where it grows) and out (INTER_CUBIC back)."""
    rng = np.random.default_rng(6)
    for h, w in ((512, 512), (256, 256), (64, 64), (448, 576)):
        pad_h, pad_w = int(np.sqrt(h / 2) * 3), int(np.sqrt(w / 2) * 3)
        ph, pw = h + 2 * pad_h, w + 2 * pad_w
        nh, nw = j_zoe._prep_size(ph, pw)
        assert (nh, nw) == zoe.prep_size(ph, pw)
        img = rng.random((ph, pw, 3)).astype(np.float32)
        flag, kind = ((cv2.INTER_AREA, "area") if nh < ph
                      else (cv2.INTER_LINEAR, "linear"))
        want = cv2.resize(img, (nw, nh), interpolation=flag)
        assert _rel(imgproc.resize(t(img), (nw, nh), kind).numpy(),
                    want) <= F32_BAR
        depth = rng.random((nh, nw)).astype(np.float32)
        want = cv2.resize(depth, (pw, ph), interpolation=cv2.INTER_CUBIC)
        assert _rel(imgproc.resize(t(depth), (pw, ph), "cubic").numpy(),
                    want) <= F32_BAR


def test_dilate_f64_against_cv2():
    rng = np.random.default_rng(7)
    x = rng.random((40, 56))
    for k in (np.ones((3, 3)), np.ones((4, 4)), np.ones((14, 14)),
              np.ones((1, 1))):
        np.testing.assert_array_equal(imgproc.dilate(t(x), k).numpy(),
                                      cv2.dilate(x, k))


def test_line_pixels_against_cv2_line_off_canvas():
    rng = np.random.default_rng(8)
    h, w = 48, 64
    for _ in range(200):
        p0 = tuple(int(v) for v in rng.integers(-80, 150, 2))
        p1 = tuple(int(v) for v in rng.integers(-80, 150, 2))
        want = np.zeros((h, w, 3), np.uint8)
        cv2.line(want, p0, p1, (255, 255, 255), 1)
        got = np.zeros((h, w), np.uint8)
        for x, y in line_pixels(w, h, p0, p1):
            got[y, x] = 255
        np.testing.assert_array_equal(got, want[:, :, 0], err_msg=str(
            (p0, p1)))


# ---------------------------------------------------------------------------
# the networks at full width
# ---------------------------------------------------------------------------

def randomize_bn(model, seed):
    """Random BatchNorm statistics and affines: a fold that dropped one of
    them would show."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for name, lo, hi in (("running_mean", -0.3, 0.3),
                                     ("running_var", 0.5, 1.5),
                                     ("weight", 0.5, 1.5),
                                     ("bias", -0.1, 0.1)):
                    v = getattr(m, name)
                    v.copy_(t(rng.uniform(lo, hi, v.shape).astype(
                        np.float32)))
    return model


def randomize_zoe(model, seed):
    """BEiT's zero-initialised parameters (layer scales, q / v biases, the
    bias tables, the cls token) made non-zero, so their wiring shows; the
    seed bins spread (x100) and the log-binomial head sharpened (x10):
    PyTorch's default init leaves every bin centre near softplus(0) and the
    metric map flat to 1e-4, where the percentile step would amplify f32
    rounding into levels."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        model.seed_bin_regressor._net[2].weight.mul_(100.0)
        model.conditional_log_binomial.mlp[2].weight.mul_(10.0)
        for name, p in model.named_parameters():
            if name.endswith(("gamma_1", "gamma_2")):
                p.copy_(t(rng.uniform(0.05, 0.15, p.shape).astype(
                    np.float32)))
            elif name.endswith(("q_bias", "v_bias", "cls_token",
                                "relative_position_bias_table")):
                p.copy_(t((rng.standard_normal(p.shape) * 0.05).astype(
                    np.float32)))
    return model


def seeded(name, seed):
    """(the port's seeded full-width network, its state dict as numpy)."""
    torch.manual_seed(seed)
    model = NETS[name][0]().eval()
    randomize_bn(model, seed)
    if name == "zoe":
        randomize_zoe(model, seed)
    return model, {k: v.detach().numpy().copy()
                   for k, v in model.state_dict().items()}


_LOG_BINOMIAL = j_zoe._log_binomial


def _eager_log_binomial(p, temp, n_classes):
    """The JAX ``_log_binomial``, run eagerly through a host callback: under
    ``jax.jit`` XLA's CPU compile of it gives NaN everywhere (its ``(n - k)
    * log(n - k + e)`` at k = n - 1); op by op it is finite."""
    shape = jax.ShapeDtypeStruct(p.shape[:-1] + (n_classes,), p.dtype)
    return jax.pure_callback(lambda a, b: np.asarray(_LOG_BINOMIAL(
        jnp.asarray(a), jnp.asarray(b), n_classes)), shape, p, temp)


@pytest.fixture
def eager_log_binomial(monkeypatch):
    monkeypatch.setattr(j_zoe, "_log_binomial", _eager_log_binomial)


def short_pix2pix(monkeypatch, levels=6):
    """The merge network at its full widths over ``levels`` levels (the
    first levels - 1 and the innermost) on both sides: ten levels need a
    1024 px input."""
    lv = leres_boost.LEVELS[:levels - 1] + leres_boost.LEVELS[-1:]
    monkeypatch.setattr(leres_boost, "LEVELS", lv)
    monkeypatch.setattr(j_boost, "_LEVELS", lv)
    return lv


# name: (port class, JAX convert, JAX apply, from_jax, NHWC input, range)
NETS = {
    "lineart_anime": (lineart_anime.UnetGenerator,
                      j_anime.convert_lineart_anime,
                      j_anime.lineart_anime_apply,
                      from_jax.lineart_anime_from_jax, (256, 256, 3),
                      (-1, 1)),
    "mlsd": (mlsd.MobileV2_MLSD_Large, j_mlsd.convert_mlsd,
             j_mlsd.mlsd_apply, from_jax.mlsd_from_jax, (64, 96, 4), (-1, 1)),
    "midas": (midas.DPTHybrid, j_midas.convert_dpt_hybrid,
              j_midas.dpt_hybrid_apply, from_jax.midas_from_jax,
              (128, 192, 3), (-1, 1)),
    "normalbae": (normalbae.NNET, j_nb.convert_nnet, j_nb.nnet_apply,
                  from_jax.normalbae_from_jax, (64, 96, 3), (-2, 2)),
    "zoe": (zoe.ZoeDepth, j_zoe.convert_zoedepth, j_zoe.zoe_apply,
            from_jax.zoe_from_jax, (96, 128, 3), (0, 1)),
    "leres": (leres.RelDepthModel, j_leres.convert_leres, j_leres.leres_apply,
              from_jax.leres_from_jax, (64, 96, 3), (0, 255)),
    "pix2pix": (leres_boost.pix2pix4depth, j_boost.convert_pix2pix4depth,
                j_boost.pix2pix_apply, from_jax.pix2pix_from_jax,
                (64, 64, 2), (-1, 1)),
}


def _nchw(x):
    return t(x.transpose(0, 3, 1, 2))


def _nhwc(y):
    y = y.numpy()
    return y.transpose(0, 2, 3, 1) if y.ndim == 4 else y


@pytest.mark.parametrize("name", list(NETS))
def test_network_matches_jax_and_carries_back(name, monkeypatch,
                                              eager_log_binomial):
    """MiDaS at 128x192 resizes its 24x24 position grid to 8x12, ZoeDepth
    at 96x128 runs the non-square 6x8 window (its bias tables resized),
    the merge network at 6 of its 10 levels (full widths) on 64x64."""
    if name == "pix2pix":
        short_pix2pix(monkeypatch)
    cls, convert, apply, back, shape, (lo, hi) = NETS[name]
    model, sd = seeded(name, 30 + list(NETS).index(name))
    params = convert(sd)
    x = np.random.default_rng(9).uniform(lo, hi, (1,) + shape).astype(
        np.float32)
    want = np.asarray(jax.jit(apply)(params, jnp.asarray(x)))
    assert np.isfinite(want).all()
    with torch.no_grad():
        # as published (BatchNorm, standardised convs at run time), then
        # folded as every detector folds it
        for fold in (False, True):
            if fold and hasattr(model, "fold"):
                model.fold()
            got = _nhwc(model(_nchw(x)))
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, **NET_TOL)
    carried = back(jax.tree.map(np.asarray, params)).state_dict()
    mine = model.state_dict()
    assert carried.keys() == mine.keys()
    for k, v in mine.items():
        assert torch.equal(carried[k], v), k


def test_published_wrappers_load(tmp_path):
    """LeReS's ``depth_model`` dict with DataParallel's ``module.``, and
    the ``model`` dict of NormalBAE and ZoeDepth (or none, for ZoeDepth),
    load through ``load_network`` as the JAX ``from_pretrained`` strips
    them (on a small module of each file's structure; the Processor tests
    load the full networks); a key the module lacks (NormalBAE's unread
    ``bn2``) is dropped."""
    from pcdms_tpu_torch.pose.detectors.common import load_network

    class Leres(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.depth_model = torch.nn.Module()
            self.depth_model.decoder_modules = leres.FTB(8, 4)
    torch.manual_seed(0)
    for cls, wrap in (
            (Leres, lambda sd: {"depth_model": {
                f"module.{k}": v for k, v in sd.items()}}),
            (zoe.ConditionalLogBinomial, lambda sd: {"model": dict(sd, **{
                "encoder.original_model.bn2.weight": torch.ones(4)})}),
            (zoe.ConditionalLogBinomial, lambda sd: sd)):
        model = cls()
        path = str(tmp_path / "w.pt")
        torch.save(wrap(model.state_dict()), path)
        loaded = load_network(cls(), path)
        for k, v in model.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), (cls, k)


def test_rel_pos_index_and_pos_embed_resize_equal_jax():
    for window in ((6, 8), (24, 24), (5, 5), (24, 32)):
        np.testing.assert_array_equal(zoe.rel_pos_index(*window),
                                      j_zoe._gen_rel_pos_index(*window))
    rng = np.random.default_rng(10)
    table = rng.standard_normal(((2 * 24 - 1) ** 2 + 3, 16)).astype(
        np.float32)
    for window in ((6, 8), (24, 32), (3, 4)):
        np.testing.assert_allclose(
            zoe.rel_pos_bias(t(table), *window).numpy(),
            np.asarray(j_zoe._rel_pos_bias(jnp.asarray(table), *window)),
            atol=1e-6, rtol=1e-6)
    pos = rng.standard_normal((1, 577, 768)).astype(np.float32)
    for grid in ((8, 12), (32, 32), (24, 24), (4, 4)):
        np.testing.assert_allclose(
            midas.resize_pos_embed(t(pos), *grid).numpy(),
            np.asarray(j_midas._resize_pos_embed(jnp.asarray(pos), *grid)),
            atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the host protocols
# ---------------------------------------------------------------------------

def _segments(a):
    return sorted(map(tuple, np.round(np.asarray(a, np.float64), 9)))


def test_decode_lines_equals_jax():
    """Crafted maps: a few strong peaks with lengths on both sides of the
    threshold, plateaus that the dilate NMS keeps whole, more candidates
    than the top 200."""
    rng = np.random.default_rng(11)
    for h, w, peaks in ((32, 48, 12), (64, 64, 400)):
        tp = (rng.standard_normal((h, w, 9)) * 0.5 - 4).astype(np.float32)
        ys, xs = rng.integers(0, h, peaks), rng.integers(0, w, peaks)
        tp[ys, xs, 0] = rng.uniform(-1, 6, peaks)
        tp[3:5, 3:6, 0] = 5.0                     # a plateau
        tp[:, :, 1:5] = rng.uniform(-6, 6, (h, w, 4))
        for thr_v, thr_d in ((0.1, 0.1), (0.5, 3.0)):
            want = j_mlsd.decode_lines(tp, thr_v, thr_d)
            got = mlsd.decode_lines(t(tp.transpose(2, 0, 1)), thr_v, thr_d)
            if peaks < 200:
                assert _segments(got) == _segments(want)
            else:
                # the 200th score ties nowhere here: the same set
                assert len(got) == len(want)
                assert _segments(got) == _segments(want)


def test_resizewithpool_equals_jax():
    rng = np.random.default_rng(12)
    for shape, size in (((96, 96), 24), ((100, 90), 14), ((448, 448), 21)):
        img = rng.normal(size=shape)
        np.testing.assert_array_equal(leres_boost.resizewithpool(img, size),
                                      j_boost._resizewithpool(img, size))


def _edgy(h, w, seed, density):
    """An image with ``density`` of its area in sharp rectangles on a
    smooth field (its gradient selects some patches and leaves others)."""
    img = _smooth(h, w, seed, cells=max(h, w) // 4)
    rng = np.random.default_rng(seed)
    for _ in range(int(density * 40)):
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
        img[y:y + rng.integers(4, h // 4), x:x + rng.integers(4, w // 4)] = \
            rng.integers(0, 256, 3)
    return img


@pytest.mark.parametrize("shape,density", [((96, 80), 0.2), ((160, 128), 1),
                                           ((256, 256), 0.05),
                                           ((200, 300), 3)])
def test_calculateprocessingres_equals_jax(shape, density):
    img = _edgy(*shape, seed=13, density=density)
    for base in (448, 128):
        want = j_boost.calculateprocessingres(img, base, 0.2, 3, 3000)
        got = leres_boost.calculateprocessingres(t(img), base, 0.2, 3, 3000)
        assert got[0] == want[0]
        assert abs(got[1] - want[1]) <= 1e-6


@pytest.mark.parametrize("factor", [0.2, 0.55, 1.0])
def test_generatepatchs_equals_jax(factor):
    img = _edgy(700, 600, seed=14, density=2)
    want = j_boost.generatepatchs(img, 256, factor)
    got = leres_boost.generatepatchs(t(img), 256, factor)
    assert got == want and len(got) > 0


def _stub_estimate_np(img, w, h):
    g = np.dot(img[..., :3].astype(np.float32) / 255.0, [0.3, 0.4, 0.3])
    return cv2.resize(cv2.resize(g, (w, h)), (img.shape[1], img.shape[0]))


def _stub_estimate(img, w, h):
    g = (img[..., :3].float() / 255.0).double() @ torch.tensor(
        [0.3, 0.4, 0.3], dtype=torch.float64)
    return imgproc.resize(imgproc.resize(g, (w, h), "linear"),
                          (img.shape[1], img.shape[0]), "linear")


def _stub_apply(_params, x):
    return (x[..., 0:1] + x[..., 1:2]) / 2.0


def _stub_merge(_net, outer, inner):
    """``merge_depths`` with ``_stub_apply`` in place of the network."""
    def norm(x):
        x = x.float()
        lo = x.min()
        return (x - lo) / max(float(x.max() - lo), 1e-12) * 2.0 - 1.0
    return ((norm(outer) + norm(inner)) / 2.0 + 1.0) / 2.0


@pytest.mark.parametrize("max_res", [4000, 64])
def test_estimateboost_equals_jax_with_stubs(max_res, monkeypatch):
    """The whole boost flow with a stub estimator and a stub merge on both
    sides (tests/test_leres_boost.py's), the patch loop included at
    max_res 4000; the merge size cut to 256 to keep the 1024 x 1024
    bicubic resizes off the CPU."""
    monkeypatch.setattr(leres_boost, "PIX2PIX_SIZE", 256)
    monkeypatch.setattr(j_boost, "_PIX2PIX_SIZE", 256)
    img = _edgy(96, 80, seed=15, density=1)
    want = j_boost.estimateboost(img, _stub_estimate_np, None,
                                 max_res=max_res, apply_fn=_stub_apply)
    log = []
    got = leres_boost.estimateboost(t(img), _stub_estimate, None,
                                    max_res=max_res, merge=_stub_merge,
                                    log=log)
    assert got.shape == want.shape == (96, 80)
    assert (len(log[0]["patches"]) > 0) == (max_res == 4000)
    # the uint8 bicubic resizes of the image (about 1e-5 of their values a
    # level off cv2's) move the stub's gray by up to 1.6e-3 there
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_percentile_and_16bit_step_equal_numpy():
    from pcdms_tpu_torch.pose.detectors.leres import normalize_16bit
    rng = np.random.default_rng(16)
    for n in (1000, 4097, 7):
        x = (rng.standard_normal(n) * 3).astype(np.float32)
        for q in (2, 85, 50, 0, 100):
            assert zoe.percentile(t(x), q) == np.percentile(x, q)
    depth = (rng.standard_normal((40, 56)) * 2).astype(np.float32)
    out = 65535.0 * (depth - depth.min()) / (depth.max() - depth.min())
    want = cv2.convertScaleAbs(out.astype(np.uint16), alpha=255.0 / 65535.0)
    np.testing.assert_array_equal(normalize_16bit(t(depth)).numpy(), want)
    flat = np.full((8, 8), 3.0, np.float32)
    assert not normalize_16bit(t(flat)).numpy().any()
