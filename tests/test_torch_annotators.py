"""The annotator facade and its first families (``pcdms_tpu_torch/pose/
imgproc.py``'s new operations, ``pose/detectors/{common,openpose,
openpose_decode,hed,pidi,lineart}.py``, ``pose/processors.py``,
``compat/from_jax.py``) against OpenCV 5.0 and the JAX package, on the CPU.

Bars:
* ``imgproc`` against cv2: every uint8 result equal pixel for pixel
  (resize by area, Lanczos-4 and bilinear, up and down, and bicubic within
  1 level on at most 0.1 % of the values; GaussianBlur;
  dilate; remap; Canny); f32 results within 2e-6 x max |cv2| (resize,
  measured <= 1.03e-6; GaussianBlur, measured <= 3.7e-7); f32 dilate
  exactly. ``resize_to_64``, ``edge_nms``, ``scribble_postprocess``,
  ``hwc3``, ``safe_step``, ``smart_resize``, ``pad_right_down`` equal the
  JAX package's (cv2) results.
* The networks at full width on 64 px inputs (PiDiNet 64, LineArt 64)
  against ``body_apply`` / ``hand_apply`` / ``face_apply`` / ``hed_apply`` /
  ``pidinet_apply`` / ``lineart_apply`` on the JAX trees that the JAX
  ``convert_*`` make from the port's ``state_dict()``: max abs error <=
  1e-5 x max |JAX| per output (f32; seeded torch inits, whose activations
  grow by orders of magnitude through the OpenPose stages). ``pdc_transform``
  exactly; ``compat/from_jax.py`` carries each JAX tree back exactly.
* The OpenPose decode (a copy) on crafted heatmaps, and each detector's
  ``__call__`` on the same image and weights, equal the JAX package's
  exactly (OpenPose with the networks' outputs replaced by a crafted
  two-person scene, hands and faces included, on both sides).
* ``Processor`` for every id of this slice against the JAX ``Processor``
  (the network ids from ``.pth`` files of the seeded networks), exactly;
  its refusals.
* Two stated uint8 bars, at most 1 level on at most 0.1 % of the values:
  HED's soft map (``hed``, ``softedge_hed``: sigmoid x 255 truncated, and
  the networks' f32 outputs differ in the last bits; LineArt's maps too)
  and ``shuffle`` (the flow's f32 bicubic upsample is
  within the f32 bar, not bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

cv2 = pytest.importorskip("cv2")

from pcdms_tpu.pose import processors as j_proc  # noqa: E402
from pcdms_tpu.pose.detectors import common as j_common  # noqa: E402
from pcdms_tpu.pose.detectors import hed as j_hed  # noqa: E402
from pcdms_tpu.pose.detectors import lineart as j_line  # noqa: E402
from pcdms_tpu.pose.detectors import openpose as j_op  # noqa: E402
from pcdms_tpu.pose.detectors import openpose_decode as j_dec  # noqa: E402
from pcdms_tpu.pose.detectors import pidi as j_pidi  # noqa: E402

from pcdms_tpu_torch.compat import from_jax  # noqa: E402
from pcdms_tpu_torch.pose import imgproc, processors  # noqa: E402
from pcdms_tpu_torch.pose.detectors import common  # noqa: E402
from pcdms_tpu_torch.pose.detectors import hed, lineart, pidi  # noqa: E402
from pcdms_tpu_torch.pose.detectors import openpose  # noqa: E402
from pcdms_tpu_torch.pose.detectors import openpose_decode as dec  # noqa
from pcdms_tpu_torch.pose.detectors import openpose_scene as scene  # noqa

from _torch_common import one_thread  # noqa: E402

F32_BAR = 2e-6
NET_BAR = 1e-5
INTERP = {"area": cv2.INTER_AREA, "lanczos4": cv2.INTER_LANCZOS4,
          "linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC}
# (source (H, W), target (H, W)): shrinking and enlarging, integer and
# ragged factors, one axis each way
RESIZE_CASES = [((37, 53), (64, 64)), ((100, 170), (64, 128)),
                ((128, 128), (64, 64)), ((96, 96), (32, 32)),
                ((131, 77), (45, 33)), ((64, 64), (512, 512)),
                ((65, 90), (128, 192)), ((100, 170), (128, 192)),
                ((46, 46), (368, 368))]


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _image(rng, h, w, c, dtype):
    if dtype == "uint8":
        x = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    else:
        x = (rng.standard_normal((h, w, c)) * 20).astype(np.float32)
    return x[..., 0] if c == 1 else x


def _person_image(h=96, w=80, seed=0):
    """A smooth seeded image (blobs on a gradient), uint8 RGB."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
    return cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)


def _assert_levels(got, want, levels=1, share=1e-3):
    """uint8 images within ``levels`` everywhere and differing in at most
    ``share`` of their values."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= levels and (d > 0).mean() <= share, (
        d.max(), (d > 0).mean())


def _assert_f32(got, want, bar=F32_BAR):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert err.max() <= bar * np.abs(want).max(), (err.max(),
                                                    np.abs(want).max())


# ---------------------------------------------------------------------------
# imgproc against cv2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("kind", ["area", "lanczos4", "linear", "cubic"])
def test_resize_equals_cv2(kind, dtype):
    rng = np.random.default_rng(1)
    for (sh, sw), (dh, dw) in RESIZE_CASES:
        for c in (1, 3):
            img = _image(rng, sh, sw, c, dtype)
            want = cv2.resize(img, (dw, dh), interpolation=INTERP[kind])
            got = imgproc.resize(t(img), (dw, dh), kind).numpy()
            assert got.shape == want.shape
            if kind == "cubic" and dtype == "uint8":
                # cv2 5.0 sums uint8 bicubic in f32 (the port's stated bar)
                _assert_levels(got, want)
            elif dtype == "uint8":
                np.testing.assert_array_equal(got, want)
            else:
                _assert_f32(got, want)


def test_resize_many_channels_equals_cv2_per_channel():
    """One call over 19 f32 channels gives cv2's per-channel results (the
    JAX ``smart_resize`` loop)."""
    x = np.random.default_rng(2).standard_normal((23, 23, 19)).astype(
        np.float32)
    for (h, w), kind in (((184, 184), "lanczos4"), ((96, 80), "area")):
        got = imgproc.resize(t(x), (w, h), kind).numpy()
        for ch in range(19):
            _assert_f32(got[..., ch], cv2.resize(
                x[..., ch], (w, h), interpolation=INTERP[kind]))


@pytest.mark.parametrize("hw,res", [((100, 170), 64), ((37, 53), 64),
                                    ((65, 91), 64), ((100, 170), 96),
                                    ((64, 64), 64), ((33, 47), 128)])
def test_resize_to_64_equals_jax(hw, res):
    """Both branches (area to shrink, Lanczos-4 to enlarge), odd sizes, an
    axis that grows under INTER_AREA, and the identity."""
    img = np.random.default_rng(3).integers(0, 256, hw + (3,), np.uint8)
    np.testing.assert_array_equal(
        common.resize_to_64(t(img), res).numpy(),
        j_common.resize_to_64(img, res))
    assert common.shape_to_64(*hw, res) == j_common.shape_to_64(*hw, res)


@pytest.mark.parametrize("sigma", [0.8, 3.0, 1.5])
def test_gaussian_blur_equals_cv2(sigma):
    rng = np.random.default_rng(4)
    for h, w, c in ((64, 64, 3), (37, 53, 1), (20, 23, 3), (9, 40, 1)):
        for dtype in ("uint8", "float32"):
            img = _image(rng, h, w, c, dtype)
            want = cv2.GaussianBlur(img, (0, 0), sigma)
            got = imgproc.gaussian_blur(t(img), sigma).numpy()
            if dtype == "uint8":
                np.testing.assert_array_equal(got, want)
            else:
                _assert_f32(got, want)


def test_dilate_equals_cv2():
    rng = np.random.default_rng(5)
    kernels = [np.ones((5, 5), np.uint8)] + [
        k.astype(np.uint8) for k in common._NMS_KERNELS]
    for dtype in ("uint8", "float32"):
        for c in (1, 3):
            img = _image(rng, 50, 61, c, dtype)
            for k in kernels:
                np.testing.assert_array_equal(
                    imgproc.dilate(t(img), k).numpy(), cv2.dilate(img, k))


def test_remap_equals_cv2():
    """The shuffle processor's maps, and maps partly off the image."""
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)
    h, w = img.shape[:2]
    flow = cv2.resize(rng.normal(size=(8, 8, 2)).astype(np.float32), (w, h),
                      interpolation=cv2.INTER_CUBIC)
    flow *= np.array([w, h], np.float32) / 8
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    maps = [(np.clip(xs + flow[..., 0], 0, w - 1),
             np.clip(ys + flow[..., 1], 0, h - 1)),
            (rng.uniform(-3, w + 3, (40, 50)).astype(np.float32),
             rng.uniform(-3, h + 3, (40, 50)).astype(np.float32))]
    for mx, my in maps:
        np.testing.assert_array_equal(
            imgproc.remap_linear(t(img), t(mx), t(my)).numpy(),
            cv2.remap(img, mx, my, cv2.INTER_LINEAR))


def _blobs(rng, h, w, c):
    img = np.zeros((h, w, 3), np.uint8)
    for _ in range(12):
        cv2.circle(img, (int(rng.integers(0, w)), int(rng.integers(0, h))),
                   int(rng.integers(3, 30)),
                   [int(v) for v in rng.integers(0, 256, 3)], -1)
    img = cv2.GaussianBlur(img, (0, 0), 1.0)
    return img if c == 3 else img[..., 0]


@pytest.mark.parametrize("low,high", [(100, 200), (50, 150), (10, 30)])
def test_canny_equals_cv2(low, high):
    rng = np.random.default_rng(7)
    for h, w, c in ((64, 64, 3), (100, 130, 3), (80, 60, 1)):
        for img in (_blobs(rng, h, w, c), _image(rng, h, w, c, "uint8")):
            np.testing.assert_array_equal(
                imgproc.canny(t(img), low, high).numpy(),
                cv2.Canny(img, low, high))


def test_edge_protocol_equals_jax():
    """``edge_nms``, ``scribble_postprocess``, ``hwc3`` and ``safe_step``
    on smooth seeded maps."""
    for seed in range(3):
        r = np.random.default_rng(seed)
        img = cv2.resize(r.integers(0, 256, (24, 24), dtype=np.uint8),
                         (96, 112), interpolation=cv2.INTER_CUBIC)
        img3 = np.stack([img] * 3, -1)
        np.testing.assert_array_equal(common.edge_nms(t(img3), 127, 3.0)
                                      .numpy(),
                                      j_common.edge_nms(img3, 127, 3.0))
        np.testing.assert_array_equal(
            common.scribble_postprocess(t(img3)).numpy(),
            j_common.scribble_postprocess(img3))
        for c in (1, 3, 4):
            x = r.integers(0, 256, (9, 7, c), dtype=np.uint8)
            np.testing.assert_array_equal(common.hwc3(t(x)).numpy(),
                                          j_common.hwc3(x))
        m = r.uniform(0, 1, (9, 7))
        np.testing.assert_array_equal(common.safe_step(t(m)).numpy(),
                                      j_common.safe_step(m))


def test_openpose_protocol_helpers_equal_jax():
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (45, 61, 3), dtype=np.uint8)
    heat = rng.standard_normal((23, 19, 19)).astype(np.float32)
    for x in (img, heat):
        for hw in ((96, 80), (184, 184), (20, 30)):
            got = openpose.smart_resize(t(x), hw).numpy()
            want = j_op.smart_resize(x, hw)
            if x.dtype == np.uint8:
                np.testing.assert_array_equal(got, want)
            else:
                _assert_f32(got, want)
        got = openpose.smart_resize_k(t(x), 0.37, 0.37).numpy()
        assert got.shape == j_op.smart_resize_k(x, 0.37, 0.37).shape
    out, pads = openpose.pad_right_down(t(img), 8, 128)
    want, want_pads = j_op.pad_right_down(img, 8, 128)
    np.testing.assert_array_equal(out.numpy(), want)
    assert pads == want_pads
    np.testing.assert_array_equal(
        openpose.bilinear_align_corners(heat, 40, 33),
        j_op.bilinear_align_corners(heat, 40, 33))


# ---------------------------------------------------------------------------
# the networks at full width
# ---------------------------------------------------------------------------

def _seeded(cls, seed):
    torch.manual_seed(seed)
    model = cls().eval()
    return model, {k: v.detach().numpy().copy()
                   for k, v in model.state_dict().items()}


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


NETS = {
    "body": (openpose.BodyPoseModel, j_op.convert_body, j_op.body_apply,
             from_jax.openpose_body_from_jax, (-0.5, 0.5)),
    "hand": (openpose.HandPoseModel, j_op.convert_hand, j_op.hand_apply,
             from_jax.openpose_hand_from_jax, (-0.5, 0.5)),
    "face": (openpose.FaceNet, j_op.convert_face, j_op.face_apply,
             from_jax.openpose_face_from_jax, (-0.5, 0.5)),
    "hed": (hed.ControlNetHED, j_hed.convert_hed, j_hed.hed_apply,
            from_jax.hed_from_jax, (0, 255)),
    "pidinet": (pidi.PiDiNet, j_pidi.convert_pidinet, j_pidi.pidinet_apply,
                from_jax.pidinet_from_jax, (0, 1)),
    "lineart": (lineart.Generator, j_line.convert_lineart,
                j_line.lineart_apply, from_jax.lineart_from_jax, (0, 1)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_network_matches_jax_and_carries_back(name):
    cls, convert, apply, back, (lo, hi) = NETS[name]
    model, sd = _seeded(cls, 10 + sorted(NETS).index(name))
    params = convert(sd)
    x = np.random.default_rng(9).uniform(lo, hi, (1, 64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = model(t(x).permute(0, 3, 1, 2))
    want = apply(params, jnp.asarray(x))
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_f32(_nhwc(g), np.asarray(w), NET_BAR)
    carried = back(params)
    if name == "pidinet":
        carried, kernels = carried
        for k, v in model.fold().items():
            assert torch.equal(kernels[k], v), k
        for k, v in carried.state_dict().items():
            if not k.endswith("conv1.weight") and k != "init_block.weight":
                assert torch.equal(v, model.state_dict()[k]), k
    else:
        for k, v in carried.state_dict().items():
            assert torch.equal(v, model.state_dict()[k]), k


@pytest.mark.parametrize("op", ["cv", "cd", "ad", "rd"])
def test_pdc_transform_equals_jax(op):
    w = np.random.default_rng(11).standard_normal((7, 5, 3, 3)).astype(
        np.float32)
    got = pidi.pdc_transform(t(w), op).numpy()
    # HWIO made contiguous, as ``t2j_conv`` gives it to the JAX converter
    want = j_pidi.pdc_transform(np.ascontiguousarray(
        np.transpose(w, (2, 3, 1, 0))), op)
    np.testing.assert_array_equal(got, np.transpose(want, (3, 2, 0, 1)))


# ---------------------------------------------------------------------------
# the OpenPose decode on crafted maps
# ---------------------------------------------------------------------------

def test_decode_equals_jax():
    heat, paf = scene.scene(96, 96)
    got_peaks = dec.find_peaks(heat.astype(np.float64), thresh=0.1)
    want_peaks = j_dec.find_peaks(heat.astype(np.float64), thresh=0.1)
    assert got_peaks == want_peaks
    cand, subset = dec.assemble_people(got_peaks, paf, 96)
    want_cand, want_subset = j_dec.assemble_people(want_peaks, paf, 96)
    np.testing.assert_array_equal(cand, want_cand)
    np.testing.assert_array_equal(subset, want_subset)
    people = dec.people_from_subset(cand, subset)
    assert len(people) == 2
    rng = np.random.default_rng(12)
    for _ in range(20):
        vis = rng.uniform(size=18) > 0.25
        kp = np.where(vis[:, None], rng.uniform([5, 5], [175, 235],
                                                size=(18, 2)), -1.0)
        p = dec.Person(kp, vis, np.ones(18), 10.0, int(vis.sum()))
        jp = j_dec.Person(kp, vis, np.ones(18), 10.0, int(vis.sum()))
        assert dec.hand_boxes(p, 240, 180) == j_dec.hand_boxes(jp, 240, 180)
        assert dec.face_box(p, 240, 180) == j_dec.face_box(jp, 240, 180)
    hands = np.stack([scene.bump(64, 64, 10 + i, 20 + i) for i in range(22)],
                     -1)
    hands[:, :, 5] = 0
    np.testing.assert_array_equal(dec.hand_peaks_from_heatmaps(hands),
                                  j_dec.hand_peaks_from_heatmaps(hands))
    np.testing.assert_array_equal(dec.face_peaks_from_heatmaps(hands[..., [
        0] * 71]), j_dec.face_peaks_from_heatmaps(hands[..., [0] * 71]))


# ---------------------------------------------------------------------------
# the detectors' __call__
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seeded_nets():
    return {name: _seeded(NETS[name][0], 20 + i)
            for i, name in enumerate(sorted(NETS))}


@pytest.fixture(scope="module")
def coarse_lineart():
    return _seeded(lineart.Generator, 40)


IMG = _person_image()


@pytest.mark.parametrize("kw", [{}, {"safe": True}, {"scribble": True}])
def test_hed_detector_equals_jax(seeded_nets, kw):
    model, sd = seeded_nets["hed"]
    want = j_hed.HEDdetector(j_hed.convert_hed(sd))(
        IMG, detect_resolution=64, image_resolution=96, **kw)
    got = hed.HEDdetector(model, device="cpu")(
        IMG, detect_resolution=64, image_resolution=96, **kw)
    if kw:
        np.testing.assert_array_equal(got, want)
    else:
        # the soft map is (sigmoid * 255) truncated: the networks' f32
        # differences move a value across an integer now and then
        _assert_levels(got, want)


@pytest.mark.parametrize("kw", [{}, {"safe": True}, {"scribble": True},
                                {"apply_filter": True}])
def test_pidinet_detector_equals_jax(seeded_nets, kw):
    model, sd = seeded_nets["pidinet"]
    want = j_pidi.PidiNetDetector(j_pidi.convert_pidinet(sd))(
        IMG, detect_resolution=64, image_resolution=128, **kw)
    got = pidi.PidiNetDetector(model, device="cpu")(
        IMG, detect_resolution=64, image_resolution=128, **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("coarse", [False, True])
def test_lineart_detector_equals_jax(seeded_nets, coarse_lineart, coarse):
    (model, sd), (cmodel, csd) = seeded_nets["lineart"], coarse_lineart
    want = j_line.LineartDetector(j_line.convert_lineart(sd),
                                  j_line.convert_lineart(csd))(
        IMG, coarse=coarse, detect_resolution=64, image_resolution=64)
    got = lineart.LineartDetector(model, cmodel, device="cpu")(
        IMG, coarse=coarse, detect_resolution=64, image_resolution=64)
    np.testing.assert_array_equal(got, want)


def test_detector_takes_pil_with_alpha_as_jax(seeded_nets):
    """A PIL image keeps its alpha, which ``hwc3`` composites onto white,
    and a grey one its single channel."""
    model, sd = seeded_nets["lineart"]
    rgba = np.concatenate([IMG, np.random.default_rng(14).integers(
        0, 256, IMG.shape[:2] + (1,), dtype=np.uint8)], -1)
    jdet = j_line.LineartDetector(j_line.convert_lineart(sd))
    det = lineart.LineartDetector(model, device="cpu")
    for img in (Image.fromarray(rgba), Image.fromarray(IMG[..., 0])):
        # a soft map, truncated: as test_hed_detector_equals_jax
        _assert_levels(det(img, detect_resolution=64, image_resolution=64),
                       jdet(img, detect_resolution=64, image_resolution=64))


@pytest.mark.parametrize("kw", [{}, {"include_hand": True,
                                     "include_face": True,
                                     "include_body": False}])
def test_openpose_detector_equals_jax(seeded_nets, kw):
    """The whole call with each network's output replaced by the crafted
    scene on both sides: the people found (two; one with its hand and face
    crops, which are resized, blurred and decoded), the render, the output
    resize."""
    people = 1 if kw else 2
    body, hand, face = (seeded_nets[k][0] for k in ("body", "hand", "face"))
    jdet = j_op.OpenposeDetector({}, {}, {})
    jdet._body = lambda p, x: tuple(jnp.asarray(a) for a in
                                    scene.network_outputs(
                                        *x.shape[1:3], people)[:2])
    jdet._hand = lambda p, x: jnp.asarray(
        scene.network_outputs(*x.shape[1:3])[2])
    jdet._face = lambda p, x: jnp.asarray(
        scene.network_outputs(*x.shape[1:3])[3])
    det = openpose.OpenposeDetector(body, hand, face, device="cpu")
    seen = []

    def forward(net, img):
        seen.append(type(net).__name__)
        paf, heat, hnd, fce = (t(a).permute(0, 3, 1, 2) for a in
                               scene.network_outputs(*img.shape[:2], people))
        return {"BodyPoseModel": (paf, heat), "HandPoseModel": hnd,
                "FaceNet": fce}[type(net).__name__]
    det._forward = forward
    img = _person_image(192, 160, seed=3)
    want = jdet(img, detect_resolution=192, image_resolution=256, **kw)
    got = det(img, detect_resolution=192, image_resolution=256, **kw)
    np.testing.assert_array_equal(got, want)
    assert want.any()
    found = det.detect_poses(img, **{k: v for k, v in kw.items()
                                     if k != "include_body"})
    assert len(found) == people
    if kw:
        assert {"HandPoseModel", "FaceNet"} <= set(seen)


# ---------------------------------------------------------------------------
# the Processor facade
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weight_files(tmp_path_factory, seeded_nets, coarse_lineart):
    """The seeded networks saved as ``.pth`` files under the modules' names
    (which the JAX converters read), PiDiNet's wrapped as a DataParallel
    checkpoint."""
    root = tmp_path_factory.mktemp("annotators")
    files = {}
    for name, (model, _) in list(seeded_nets.items()) + [
            ("coarse", coarse_lineart)]:
        sd = model.state_dict()
        if name == "pidinet":
            sd = {"state_dict": {f"module.{k}": v for k, v in sd.items()}}
        files[name] = str(root / f"{name}.pth")
        torch.save(sd, files[name])
    return files


def _both(pid, params=None):
    rng = np.random.default_rng(13)
    # tall: OpenPose's body input is 184 px high whatever the image
    img = _person_image(128, 64, seed=4)
    if pid in ("none", "resize", "canny", "scribble", "shuffle"):
        img = rng.integers(0, 256, (48, 56, 3), dtype=np.uint8)
    want = j_proc.Processor(pid, dict(params or {}))(img, to_pil=False)
    got = processors.Processor(pid, dict(params or {}),
                               device="cpu")(img, to_pil=False)
    return got, want


@pytest.mark.parametrize("pid,params", [
    ("none", None), ("resize", None), ("canny", None),
    ("canny", {"low_threshold": 20, "high_threshold": 60}),
    ("scribble", None), ("shuffle", {"seed": 3}), ("shuffle", None)])
def test_processor_plain_ids_equal_jax(pid, params):
    got, want = _both(pid, params)
    if pid == "shuffle":
        # the flow's f32 bicubic upsample is within 2e-6 of cv2's, not
        # bit for bit: a remap tap lands on the other side of a rounding
        _assert_levels(got, want)
    else:
        np.testing.assert_array_equal(got, want)


_NET_IDS = {
    "hed": "hed", "hed_safe": "hed", "scribble_hed": "hed",
    "softedge_hed": "hed", "softedge_hedsafe": "hed",
    "scribble_pidinet": "pidinet", "softedge_pidinet": "pidinet",
    "softedge_pidsafe": "pidinet", "lineart_realistic": "lineart",
    "lineart_coarse": "coarse", "openpose": "body", "openpose_face": "body",
    "openpose_faceonly": "body", "openpose_full": "body",
    "openpose_hand": "body",
}


_JAX_NETS = {}


@pytest.fixture
def shared_jax_jit(monkeypatch):
    """The JAX detectors jit their networks per instance; one jitted
    function per network across the Processor ids keeps the JAX side to
    one compile a network."""
    for cls, attrs in ((j_op.OpenposeDetector, {"_body": j_op.body_apply,
                                                "_hand": j_op.hand_apply,
                                                "_face": j_op.face_apply}),
                       (j_hed.HEDdetector, {"_apply": j_hed.hed_apply}),
                       (j_pidi.PidiNetDetector,
                        {"_apply": j_pidi.pidinet_apply}),
                       (j_line.LineartDetector,
                        {"_apply": j_line.lineart_apply})):
        init = cls.__init__

        def shared(self, *a, _init=init, _attrs=attrs, **k):
            _init(self, *a, **k)
            for name, fn in _attrs.items():
                setattr(self, name, _JAX_NETS.setdefault(fn, jax.jit(fn)))
        monkeypatch.setattr(cls, "__init__", shared)


@pytest.mark.parametrize("pid", sorted(_NET_IDS))
def test_processor_network_ids_equal_jax(pid, weight_files, shared_jax_jit):
    params = {"weights": weight_files[_NET_IDS[pid]],
              "hand_weights": weight_files["hand"],
              "face_weights": weight_files["face"],
              "detect_resolution": 64, "image_resolution": 64}
    got, want = _both(pid, params)
    if pid in ("hed", "softedge_hed", "lineart_realistic",
               "lineart_coarse"):
        _assert_levels(got, want)       # soft maps: as the HED test
    else:
        np.testing.assert_array_equal(got, want)
    assert isinstance(processors.Processor(pid, params, device="cpu")(got),
                      Image.Image)


def test_released_openpose_layout_loads(tmp_path, seeded_nets):
    """controlnet-aux's released body / hand files name a conv without its
    block (``conv1_1.weight``); ``load_network`` maps them as its
    ``util.transfer`` does."""
    for name, cls in (("body", openpose.BodyPoseModel),
                      ("hand", openpose.HandPoseModel)):
        model = seeded_nets[name][0]
        path = str(tmp_path / f"{name}.pth")
        torch.save({k.split(".", 1)[1]: v
                    for k, v in model.state_dict().items()}, path)
        loaded = common.load_network(cls(), path)
        for k, v in loaded.state_dict().items():
            assert torch.equal(v, model.state_dict()[k]), k


def test_processor_dwpose_routes_to_the_port(monkeypatch):
    """dwpose / dwpose_body build ``DWposeTorch.from_torch`` on the
    Processor's device and return its render; the ONNX route refuses as
    ``cli/extract_pose.py`` does without onnxruntime."""
    from pcdms_tpu_torch.pose import dwpose
    calls = []

    class Stub:
        def __call__(self, img):
            calls.append(img.shape)
            return np.full(img.shape, 7, np.uint8), None, None

    monkeypatch.setattr(dwpose.DWposeTorch, "from_torch", classmethod(
        lambda cls, det, pose, device=None: calls.append(
            (det, pose, str(device))) or Stub()))
    for pid in ("dwpose", "dwpose_body"):
        out = processors.Processor(pid, {"det_torch": "d.pth",
                                         "pose_torch": "p.pth"},
                                   device="cpu")(IMG, to_pil=False)
        assert (out == 7).all() and out.shape == IMG.shape
    assert calls[0] == ("d.pth", "p.pth", "cpu")
    with pytest.raises(ImportError, match="onnxruntime"):
        processors.Processor("dwpose", {"det_onnx": "d.onnx",
                                        "pose_onnx": "p.onnx"}, device="cpu")


@pytest.mark.parametrize("pid", sorted(_NET_IDS))
def test_processor_refuses_without_weights_as_jax(pid):
    with pytest.raises(NotImplementedError, match="needs its pretrained"):
        j_proc.Processor(pid)
    with pytest.raises(NotImplementedError, match="needs its pretrained"):
        processors.Processor(pid, device="cpu")


# the ids this slice left to later ones (the depth, normal, M-LSD, anime
# line-art and SAM ids) are all ported since, and refuse only for want of
# their weights, as the JAX facade does
@pytest.mark.parametrize("pid", sorted(set(j_proc._IMPLEMENTED_NN)
                                       - set(_NET_IDS)))
def test_processor_refuses_unported_families(pid):
    assert pid not in processors._NOT_PORTED
    assert pid in processors._IMPLEMENTED_NN
    with pytest.raises(NotImplementedError, match="needs its pretrained"):
        processors.Processor(pid, device="cpu")


def test_processor_other_refusals():
    import importlib.util
    if importlib.util.find_spec("mediapipe") is None:
        with pytest.raises(NotImplementedError, match="mediapipe"):
            processors.Processor("mediapipe_face", device="cpu")
    with pytest.raises(ValueError, match="unknown processor"):
        processors.Processor("nope", device="cpu")
    assert set(processors._IMPLEMENTED_NN) | set(processors._NOT_PORTED) \
        == set(j_proc._IMPLEMENTED_NN)
    assert processors._OPENPOSE_FLAGS == j_proc._OPENPOSE_FLAGS
    assert processors.Processor._CTOR_KEYS == j_proc.Processor._CTOR_KEYS
