"""The DWPose extraction path (``pcdms_tpu_torch/pose/dwpose.py``,
``pose/imgproc.py``, ``pose/detectors/``, ``cli/extract_pose.py``) against
the JAX package's, on the CPU, from inputs made with numpy from a seed.

* YOLOX-l and RTMPose-l at full width: the port's seeded modules, with
  random BatchNorm statistics (mean ~ N(0, 0.3), var ~ U(0.5, 1.5)), give
  their ``state_dict()`` (mm key names) to ``convert_yolox`` /
  ``convert_rtmpose``; ``yolox_apply`` at a 128x128 input and
  ``rtmpose_apply`` at 384x288 under ``jax.jit`` against the port's forward
  before and after its BatchNorm folding, and the JAX trees carried back by
  ``compat/from_jax.py::{yolox,rtmpose}_from_jax``: atol 5e-4 / rtol 5e-4,
  the JAX suite's bar for these networks.
* The protocol: ``_letterbox`` (``resize_linear``), ``_pose_crop``
  (``get_affine_transform``, ``warp_affine_linear``), ``_simcc_to_image``
  (``invert_affine_transform``), ``_nms``, ``decode_yolox`` and
  ``_bbox_to_center_scale`` equal the JAX package's (cv2 5.0) exactly, on
  seeded random and blurred images at 1101x750, 1024x768, 512x352, 256x176
  and 96x64, with crops partly off the image.
* ``load_torch_state_dict``'s unwrapping equals the JAX package's.
* ``DWposeDetector.__call__`` with stub ONNX sessions (the cases of
  ``tests/test_dwpose_numeric.py``) and with stub networks for the hands:
  render, keypoints and scores equal to the JAX detector's, exactly.
* ``DWposeTorch`` against ``DWposeJAX`` from the same weights, the
  detection pinned to one box: the same crop, SimCC logits (and so the
  scores, their maxima) within the bar, the decoded keypoints and the
  render equal (every keypoint's top-two logit margin exceeds 1e-3 at this
  seed).
* ``cli/extract_pose.main`` (``--det_ckpt`` / ``--pose_ckpt``, wrapped mm
  checkpoints) on 2 synthetic images against the JAX CLI with a
  ``DWposeJAX`` of the same weights, both with the same pinned boxes: the
  ``.txt`` files and the ``_pose.jpg`` renders equal byte for byte.

No JAX initialiser runs here (``yolox_init`` / ``rtmpose_init`` compile op
by op for over 10 s each) and no 640 px YOLOX forward.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

cv2 = pytest.importorskip("cv2")

from pcdms_tpu.cli import extract_pose as j_cli  # noqa: E402
from pcdms_tpu.pose import dwpose as jd  # noqa: E402
from pcdms_tpu.pose.detectors import common as j_common  # noqa: E402
from pcdms_tpu.pose.detectors import rtmpose as j_rtmpose  # noqa: E402
from pcdms_tpu.pose.detectors import yolox as j_yolox  # noqa: E402

from pcdms_tpu_torch.cli import extract_pose  # noqa: E402
from pcdms_tpu_torch.compat.from_jax import (  # noqa: E402
    rtmpose_from_jax, yolox_from_jax,
)
from pcdms_tpu_torch.pose import dwpose as td  # noqa: E402
from pcdms_tpu_torch.pose import imgproc  # noqa: E402
from pcdms_tpu_torch.pose.detectors.common import (  # noqa: E402
    fold_bn, load_torch_state_dict,
)
from pcdms_tpu_torch.pose.detectors.rtmpose import RTMPose  # noqa: E402
from pcdms_tpu_torch.pose.detectors.yolox import YOLOX  # noqa: E402

from _torch_common import one_thread  # noqa: E402

TOL = dict(atol=5e-4, rtol=5e-4)
# the sizes of the measurements the protocol was checked at
IMAGE_SIZES = [(1101, 750), (1024, 768), (512, 352), (256, 176), (96, 64)]
N_CELLS = 80 * 80 + 40 * 40 + 20 * 20        # 640 input, strides 8/16/32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _randomize_bn(model, rng):
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(rng.normal(
                    0, 0.3, m.running_mean.shape).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(
                    0.5, 1.5, m.running_var.shape).astype(np.float32)))


def _seeded(cls, seed):
    """(the port's module at ``seed`` with random BatchNorm statistics, its
    mm state dict as numpy)."""
    torch.manual_seed(seed)
    model = cls().eval()
    _randomize_bn(model, np.random.default_rng(seed))
    return model, {k: v.numpy().copy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def yolox_pair():
    """(unfolded port YOLOX-l, its mm state dict, the JAX tree), seed 0."""
    model, sd = _seeded(YOLOX, 0)
    return model, sd, j_yolox.convert_yolox(sd)


@pytest.fixture(scope="module")
def rtmpose_pair():
    """(unfolded port RTMPose-l, its mm state dict, the JAX tree), seed 1."""
    model, sd = _seeded(RTMPose, 1)
    return model, sd, j_rtmpose.convert_rtmpose(sd)


def _folded(model):
    import copy
    return fold_bn(copy.deepcopy(model))


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# --------------------------------------------------------------- networks --

def test_yolox_matches_jax(yolox_pair):
    model, sd, params = yolox_pair
    assert any(k.startswith("bbox_head.multi_level_conv_obj.2") for k in sd)
    x = np.random.default_rng(10).uniform(0, 255, (1, 128, 128, 3)
                                          ).astype(np.float32)
    want = np.asarray(jax.jit(j_yolox.yolox_apply)(params, jnp.asarray(x)))
    assert want.shape == (1, 16 * 16 + 8 * 8 + 4 * 4, 85)
    with torch.no_grad():
        for net in (model, _folded(model), yolox_from_jax(
                _numpy_tree(params))):
            np.testing.assert_allclose(net(_nchw(x)).numpy(), want, **TOL)


def test_rtmpose_matches_jax(rtmpose_pair):
    model, sd, params = rtmpose_pair
    assert "head.gau.res_scale.scale" in sd and "head.mlp.0.g" in sd
    x = np.random.default_rng(11).uniform(0, 255, (1, 384, 288, 3)
                                          ).astype(np.float32)
    want = jax.jit(j_rtmpose.rtmpose_apply)(params, jnp.asarray(x))
    assert want[0].shape == (1, 133, 576) and want[1].shape == (1, 133, 768)
    with torch.no_grad():
        for net in (model, _folded(model), rtmpose_from_jax(
                _numpy_tree(params))):
            for got, w in zip(net(_nchw(x)), want):
                np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("which", ["yolox", "rtmpose"])
def test_from_jax_gives_the_folded_weights(which, yolox_pair, rtmpose_pair):
    """The JAX tree carried back is the port's own folding of the same mm
    weights: every folded conv, the depthwise ones and the head's
    linears."""
    model, _, params = yolox_pair if which == "yolox" else rtmpose_pair
    back = (yolox_from_jax if which == "yolox" else rtmpose_from_jax)(
        _numpy_tree(params)).state_dict()
    mine = _folded(model).state_dict()
    assert back.keys() == mine.keys()
    for k in mine:
        np.testing.assert_allclose(back[k].numpy(), mine[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_fold_bn_once():
    model = _folded(_seeded(RTMPose, 2)[0])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    fold_bn(model)
    after = model.state_dict()
    assert not any(".bn." in k for k in after)
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_load_torch_state_dict_unwraps_as_jax(tmp_path):
    sd = {"a.weight": torch.arange(6.).view(2, 3),
          "b.module.bias": torch.ones(2)}
    wrapped = {k.replace("a.", "module.a."): v for k, v in sd.items()}
    for i, obj in enumerate([sd, {"state_dict": sd}, {"model": wrapped},
                             {"module": wrapped, "meta": {"epoch": 3}},
                             {"state_dict": {"model": wrapped}},
                             {"state_dict": sd, "model": "not a dict"}]):
        path = str(tmp_path / f"ckpt{i}.pth")
        torch.save(obj, path)
        got, want = load_torch_state_dict(path), \
            j_common.load_torch_state_dict(path)
        assert got.keys() == want.keys() == {"a.weight", "b.bias"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------------- protocol --

def _image(rng, h, w, blur):
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return cv2.GaussianBlur(img, (0, 0), 3) if blur else img


@pytest.mark.parametrize("blur", [False, True])
@pytest.mark.parametrize("hw", IMAGE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_letterbox_equals_jax(hw, blur):
    img = _image(np.random.default_rng(hw[0] + blur), *hw, blur)
    want, r_want = jd._letterbox(img, 640)
    got, r = td._letterbox(img, 640)
    assert r == r_want and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_resize_linear_equals_cv2():
    """Up, down, by exactly 2, to the same size, one-pixel edges."""
    rng = np.random.default_rng(5)
    shapes = [((40, 60), (20, 30)), ((40, 60), (40, 60)), ((1, 7), (3, 2)),
              ((7, 1), (9, 4))]
    shapes += [((int(rng.integers(2, 200)), int(rng.integers(2, 200))),
                (int(rng.integers(1, 300)), int(rng.integers(1, 300))))
               for _ in range(40)]
    for (h, w), (nh, nw) in shapes:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        got = imgproc.resize_linear(torch.from_numpy(img), (nw, nh))
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{(h, w)} -> {(nh, nw)}")


def _boxes(h, w):
    """Three person boxes: inside, across the top-left corner, across the
    bottom-right one."""
    return [(0.13 * w, 0.11 * h, 0.53 * w, 0.82 * h),
            (-0.07 * w, 0.03 * h, 0.27 * w, 0.27 * h),
            (0.6 * w, 0.5 * h, 1.2 * w, 1.05 * h)]


@pytest.mark.parametrize("blur", [False, True])
@pytest.mark.parametrize("hw", [(1101, 750), (512, 352)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pose_crop_equals_jax(hw, blur):
    img = _image(np.random.default_rng(7 + blur), *hw, blur)
    for box in _boxes(*hw):
        want, mat_want = jd._pose_crop(img, box)
        got, mat = td._pose_crop(img, box)
        np.testing.assert_array_equal(mat, mat_want)
        np.testing.assert_array_equal(got.numpy(), want)


def test_affine_helpers_equal_cv2():
    rng = np.random.default_rng(8)
    for _ in range(200):
        src = rng.uniform(-500, 1500, (3, 2)).astype(np.float32)
        dst = rng.uniform(-10, 700, (3, 2)).astype(np.float32)
        mat = cv2.getAffineTransform(src, dst)
        np.testing.assert_array_equal(imgproc.get_affine_transform(src, dst),
                                      mat)
        np.testing.assert_array_equal(imgproc.invert_affine_transform(mat),
                                      cv2.invertAffineTransform(mat))
    line = np.array([[0, 0], [1, 1], [2, 2]], np.float32)
    np.testing.assert_array_equal(imgproc.get_affine_transform(line, line),
                                  np.zeros((2, 3)))


def test_swap_rb_equals_cvtcolor():
    img = np.random.default_rng(9).integers(0, 256, (5, 7, 3), np.uint8)
    np.testing.assert_array_equal(
        imgproc.swap_rb(torch.from_numpy(img)).numpy(),
        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def test_simcc_to_image_equals_jax():
    rng = np.random.default_rng(12)
    for box in _boxes(1101, 750):
        _, mat = jd._pose_crop(np.zeros((1101, 750, 3), np.uint8), box)
        sx = rng.normal(0, 1, (133, 576)).astype(np.float32)
        sy = rng.normal(0, 1, (133, 768)).astype(np.float32)
        for got, want in zip(td._simcc_to_image(sx, sy, mat),
                             jd._simcc_to_image(sx, sy, mat)):
            np.testing.assert_array_equal(got, want)


def test_nms_and_decode_equal_jax():
    rng = np.random.default_rng(13)
    for _ in range(20):
        xy = rng.uniform(0, 600, (60, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 200, (60, 2))], 1
                               ).astype(np.float32)
        # ties: a quarter of the scores repeat
        scores = rng.choice(rng.uniform(0, 1, 45), 60).astype(np.float32)
        assert td._nms(boxes, scores) == jd._nms(boxes, scores)
    for size in (640, 128):
        n = sum((size // s) ** 2 for s in (8, 16, 32))
        preds = rng.normal(0, 1, (1, n, 85)).astype(np.float32)
        preds[..., 4:] = rng.uniform(0, 1, (1, n, 81))
        for ratio in (1.0, 0.64):
            got = td.decode_yolox(preds, ratio, input_size=size)
            want = jd.decode_yolox(preds, ratio, input_size=size)
            assert len(got[0]) > 1
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_bbox_to_center_scale_equals_jax():
    for box in ([0, 0, 300, 100], [0, 0, 30, 400], [3.5, 7.25, 60.1, 90.2]):
        for g, w in zip(td._bbox_to_center_scale(box),
                        jd._bbox_to_center_scale(box)):
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------------- the shared call --

def _raw_yolox(entries):
    """entries: list of (cell_index, dx, dy, log_w, log_h, obj, person)."""
    out = np.zeros((1, N_CELLS, 85), np.float32)
    out[..., 2:4] = -10.0                     # exp(-10) ~ 0 size elsewhere
    for idx, dx, dy, lw, lh, obj, person in entries:
        out[0, idx, :2] = (dx, dy)
        out[0, idx, 2:4] = (lw, lh)
        out[0, idx, 4] = obj
        out[0, idx, 5] = person
    return out


def _simcc_for(crop_pts, n_kpts=133):
    sx = np.zeros((1, n_kpts, 288 * 2), np.float32)
    sy = np.zeros((1, n_kpts, 384 * 2), np.float32)
    for k in range(n_kpts):
        x, y = crop_pts[min(k, len(crop_pts) - 1)]
        sx[0, k, int(round(x * 2))] = 9.0
        sy[0, k, int(round(y * 2))] = 9.0
    return [sx, sy]


class _StubSession:
    def __init__(self, fn):
        self.fn = fn

    def get_inputs(self):
        class _I:
            name = "input"
        return [_I()]

    def run(self, _, feeds):
        return self.fn(feeds["input"])


def _stub_detectors(det_fn, pose_fn):
    out = []
    for cls in (jd.DWposeDetector, td.DWposeDetector):
        d = cls.__new__(cls)
        d.det, d.pose = _StubSession(det_fn), _StubSession(pose_fn)
        out.append(d)
    return out


def _assert_calls_equal(j_det, t_det, img, **kwargs):
    want, got = j_det(img, **kwargs), t_det(img, **kwargs)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    return got


def test_call_round_trip_equals_jax():
    """The stub detector places one person; the stub SimCC logits put the
    keypoints at spread crop points. Blobs, render, keypoints and scores
    equal the JAX detector's."""
    blobs = {}

    def det_fn(blob):
        blobs.setdefault("det", []).append(blob)
        return [_raw_yolox([(25 * 80 + 20, 0.5, 0.5, np.log(10.0),
                             np.log(15.0), 1.0, 1.0)])]

    def pose_fn(blob):
        blobs.setdefault("pose", []).append(blob)
        pts = [(20.0 + 12 * (k % 20), 30.0 + 15 * (k // 6)) for k in range(23)]
        return _simcc_for(pts)

    img = np.random.default_rng(14).integers(0, 256, (400, 320, 3), np.uint8)
    render, kpts, scores = _assert_calls_equal(*_stub_detectors(
        det_fn, pose_fn), img)
    assert render.shape == (400, 320, 3) and kpts.shape == (1, 18, 2)
    assert (scores > 0.3).any() and render.any()
    for key in ("det", "pose"):
        (want, got) = blobs[key]
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    _assert_calls_equal(*_stub_detectors(det_fn, pose_fn), img,
                        render_size=(128, 96))


def test_no_person_equals_jax():
    j_det, t_det = _stub_detectors(lambda blob: [_raw_yolox([])],
                                   lambda blob: _simcc_for([(0.0, 0.0)]))
    render, kpts, _ = _assert_calls_equal(
        j_det, t_det, np.zeros((64, 64, 3), np.uint8))
    assert kpts.shape == (0, 18, 2) and not render.any()


def _fake_pose(hand_scores):
    def estimate_pose(img, box):
        pts = np.full((133, 2), -10.0, np.float32)
        scores = np.zeros(133, np.float32)
        pts[:17] = [[32, 10], [34, 14], [30, 14], [36, 18], [28, 18],
                    [40, 26], [24, 26], [44, 40], [20, 40], [46, 52],
                    [18, 52], [38, 56], [26, 56], [40, 74], [24, 74],
                    [40, 90], [24, 90]]
        scores[:17] = 0.9
        for i in range(21):
            pts[91 + i] = [46 + i % 4, 52 + i // 4]
            pts[112 + i] = [10 + 2 * (i % 5), 50 + 2 * (i // 5)]
        scores[91:133] = hand_scores
        return pts, scores
    return estimate_pose


def test_call_renders_hands_as_jax():
    """Wholebody 91:112 / 112:133 reach the renderer, points under 0.3
    masked to -1: equal to the JAX render, and the hands add pixels."""
    renders = []
    hand_scores = np.random.default_rng(15).uniform(0, 1, 42)
    for scores in (hand_scores, np.zeros(42)):
        dets = _stub_detectors(None, None)
        for d in dets:
            d.detect_persons = lambda img: (np.array([[4.0, 4.0, 60.0, 90.0]]),
                                            np.array([0.9]))
            d.estimate_pose = _fake_pose(scores)
        renders.append(_assert_calls_equal(
            *dets, np.zeros((96, 64, 3), np.uint8),
            render_size=(192, 128))[0])
    assert (renders[0] != renders[1]).any()


def test_onnx_path_refuses_without_onnxruntime():
    try:
        import onnxruntime  # noqa: F401
        pytest.skip("onnxruntime is installed")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="onnxruntime"):
        td.DWposeDetector("det.onnx", "pose.onnx")


# ------------------------------------------------- the two networks' call --

def _pinned(det, box):
    det.detect_persons = lambda image_rgb: (np.array([box]),
                                            np.array([0.9]))
    return det


@pytest.fixture(scope="module")
def detector_pair(yolox_pair, rtmpose_pair):
    """(DWposeJAX, DWposeTorch on the CPU) on the same weights, det 128."""
    j_det = jd.DWposeJAX(yolox_pair[2], rtmpose_pair[2], det_size=128)
    t_det = td.DWposeTorch(_folded(yolox_pair[0]), _folded(rtmpose_pair[0]),
                           det_size=128, device="cpu")
    return j_det, t_det


def test_detect_persons_equals_jax(detector_pair):
    """The whole detection path at a 128 letterbox: the same boxes (random
    weights give few or none), and the raw outputs within the bar."""
    j_det, t_det = detector_pair
    img = _image(np.random.default_rng(16), 96, 64, blur=True)
    inp, _ = jd._letterbox(cv2.cvtColor(img, cv2.COLOR_RGB2BGR), 128)
    want = np.asarray(j_det._det(j_det.det_params,
                                 jnp.asarray(inp, jnp.float32)[None]))
    with torch.no_grad():
        got = t_det.det(_nchw(inp[None].astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for g, w in zip(t_det.detect_persons(img), j_det.detect_persons(img)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4)


def test_dwpose_torch_equals_jax(detector_pair):
    j_det, t_det = detector_pair
    img = _image(np.random.default_rng(17), 160, 120, blur=True)
    box = [20.0, 12.0, 100.0, 150.0]
    crop, _ = jd._pose_crop(img, box)
    want = [np.asarray(v[0]) for v in j_det._pose(
        j_det.pose_params, jnp.asarray(crop, jnp.float32)[None])]
    got = [v[0].numpy() for v in t_det._forward(
        t_det.pose, td._pose_crop(img, box)[0])]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
        top2 = np.sort(w, -1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > 1e-3).all()
    kwargs = dict(render_size=(256, 192))
    want = _pinned(j_det, box)(img, **kwargs)
    render, kpts, scores = _pinned(t_det, box)(img, **kwargs)
    np.testing.assert_array_equal(render, want[0])
    np.testing.assert_array_equal(kpts, want[1])
    # the scores are the logits' maxima
    np.testing.assert_allclose(scores, want[2], **TOL)


def test_forward_runs_in_f32_and_restores_the_callers_settings():
    """``_forward`` runs the networks with TF32 off for cuDNN and for the
    matmuls, whatever the caller set, and gives the caller's settings back
    (the JAX package runs both networks in f32)."""
    seen = []

    def net(x):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return x

    prev = (torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        out = td.DWposeTorch._forward(
            None, net, torch.zeros(4, 3, 3, dtype=torch.uint8))
        after = (torch.backends.cudnn.allow_tf32,
                 torch.get_float32_matmul_precision())
    finally:
        torch.backends.cudnn.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])
    assert out.shape == (1, 3, 4, 3) and out.dtype == torch.float32
    assert seen == [(False, "highest")]
    assert after == (True, "high")


# --------------------------------------------------------------------- CLI --

def _synthetic_images(root, n=2):
    rng = np.random.default_rng(18)
    os.makedirs(root)
    for i in range(n):
        Image.fromarray(_image(rng, 150 + 20 * i, 110, blur=True)).save(
            os.path.join(root, f"img{i}.png"))


def test_extract_pose_cli_equals_jax(tmp_path, yolox_pair, rtmpose_pair,
                                     monkeypatch):
    images = str(tmp_path / "images")
    _synthetic_images(images)
    det_ckpt, pose_ckpt = str(tmp_path / "det.pth"), str(tmp_path / "pose.pth")
    # the mm wrappers: a state_dict dict, DeepSpeed-style "module." keys
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in yolox_pair[1].items()},
                "meta": {"epoch": 300}}, det_ckpt)
    torch.save({"module": {f"module.{k}": torch.from_numpy(v)
                           for k, v in rtmpose_pair[1].items()}}, pose_ckpt)
    box = np.array([[10.0, 20.0, 100.0, 140.0], [30.0, 5.0, 90.0, 120.0]])
    scores = np.array([0.9, 0.8])

    def j_detector(det_onnx, pose_onnx):
        det = jd.DWposeJAX.from_torch(det_ckpt, pose_ckpt)
        det.detect_persons = lambda img: (box, scores)
        return det

    monkeypatch.setattr(jd, "DWposeDetector", j_detector)
    monkeypatch.setattr(td.DWposeTorch, "detect_persons",
                        lambda self, img: (box, scores))
    outs = {}
    for name, run, flags in (
            ("jax", j_cli.main, ["--det_onnx", "d", "--pose_onnx", "p"]),
            ("torch", extract_pose.main,
             ["--det_ckpt", det_ckpt, "--pose_ckpt", pose_ckpt,
              "--device", "cpu"])):
        txt, pose = str(tmp_path / name / "txt"), str(tmp_path / name / "p")
        run(["--image_dir", images, "--out_txt_dir", txt, "--out_pose_dir",
             pose, "--image_resolution", "64", *flags])
        outs[name] = {}
        for root in (txt, pose):
            for f in os.listdir(root):
                with open(os.path.join(root, f), "rb") as fh:
                    outs[name][f] = fh.read()
    assert sorted(outs["torch"]) == sorted(outs["jax"]) == [
        "img0.txt", "img0_pose.jpg", "img1.txt", "img1_pose.jpg"]
    assert outs["torch"] == outs["jax"]
    lines = outs["torch"]["img0.txt"].decode().splitlines()
    assert len(lines) == 18
    with Image.open(tmp_path / "torch" / "p" / "img1_pose.jpg") as im:
        assert im.size == (64, 64)


@pytest.mark.parametrize("flags", [
    [], ["--det_ckpt", "a"], ["--det_onnx", "a", "--pose_onnx", "b",
                              "--det_ckpt", "c", "--pose_ckpt", "d"],
    ["--det_onnx", "a", "--pose_ckpt", "b"]])
def test_extract_pose_cli_needs_exactly_one_pair(flags, tmp_path):
    with pytest.raises(SystemExit):
        extract_pose.parse_args(["--image_dir", ".", "--out_txt_dir", "t",
                                 "--out_pose_dir", "p", *flags])
