"""The learning proof's world and driver against the JAX package, on the
CPU:

* ``pose/raster.py`` against cv2 itself: ``ellipse2poly`` against
  ``cv2.ellipse2Poly``, ``line_pixels`` against ``cv2.line`` (clipped ends
  too), ``fill_convex_poly`` against ``cv2.fillConvexPoly`` on ellipses and
  convex hulls that cross the border, ``fill_circle`` against
  ``cv2.circle(thickness=-1)``: pixel for pixel, over seeded random inputs;
* ``pose/skeleton.py::render_pose`` against the JAX package's (cv2) at 64,
  128 and 512 px over seeded random poses and visibility masks: pixel for
  pixel;
* ``data/synthetic.py`` against the JAX package's: every palette and pose
  equal, and ``generate_dataset``'s files byte for byte (PNGs, the
  quality-95 JPEG renders, the ``.txt`` keypoints, the pair JSONs);
* ``data/native.py`` against the JAX package's ctypes copy: every function
  equal; the port builds into ``build/`` and leaves ``native/`` as it was;
* ``cli/learning_proof.py`` at a tiny budget (2 identities x 4 poses, 2
  steps per stage, 1 inference step): every stage hands its files on and
  ``learning_proof.json`` has the keys of the JAX run's
  ``LEARNING_PROOF_r05.json``. The ``--quick`` run (the JAX script's quick
  budget with 600 stage-3 steps, ``cli/learning_proof.py::_apply_quick``)
  with the JAX test's thresholds (``--assert_improves``) is slow, as the
  JAX one is.
"""

import hashlib
import json
import os
from pathlib import Path

import cv2
import numpy as np
import pytest

from pcdms_tpu.data import native as j_native
from pcdms_tpu.data import synthetic as j_synthetic
from pcdms_tpu.pose.skeleton import render_pose as j_render_pose

from pcdms_tpu_torch.data import native, synthetic
from pcdms_tpu_torch.pose import raster
from pcdms_tpu_torch.pose.skeleton import render_pose

from _torch_common import one_thread

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


# ----------------------------------------------------------------- raster --

def test_ellipse2poly_equals_cv2():
    rng = np.random.default_rng(0)
    for _ in range(3000):
        center = (int(rng.integers(-20, 600)), int(rng.integers(-20, 600)))
        axes = (int(rng.integers(0, 300)), int(rng.integers(0, 8)))
        angle = int(rng.integers(-400, 400))
        want = cv2.ellipse2Poly(center, axes, angle, 0, 360, 1)
        got = raster.ellipse2poly(center, axes, angle)
        assert got == [tuple(p) for p in want.tolist()], (center, axes,
                                                          angle)


def test_line_pixels_equal_cv2():
    rng = np.random.default_rng(1)
    for _ in range(2000):
        w, h = int(rng.integers(5, 80)), int(rng.integers(5, 80))
        p1 = (int(rng.integers(-30, 110)), int(rng.integers(-30, 110)))
        p2 = (int(rng.integers(-30, 110)), int(rng.integers(-30, 110)))
        want = np.zeros((h, w, 3), np.uint8)
        cv2.line(want, p1, p2, (255, 255, 255), 1, 8)
        got = np.zeros((h, w, 3), np.uint8)
        for x, y in raster.line_pixels(w, h, p1, p2):
            got[y, x] = 255
        assert (got == want).all(), (w, h, p1, p2)


def test_fill_convex_poly_equals_cv2():
    rng = np.random.default_rng(2)
    for i in range(2000):
        w, h = int(rng.integers(5, 130)), int(rng.integers(5, 130))
        if i % 2:
            center = (int(rng.integers(-30, 160)),
                      int(rng.integers(-30, 160)))
            axes = (int(rng.integers(0, 80)), int(rng.integers(0, 8)))
            pts = np.asarray(raster.ellipse2poly(
                center, axes, int(rng.integers(-180, 180))), np.int32)
        else:
            pts = rng.integers(-40, 140, (int(rng.integers(1, 12)), 2)
                               ).astype(np.int32)
            if len(pts) >= 3:
                pts = cv2.convexHull(pts)[:, 0]
        want = np.zeros((h, w, 3), np.uint8)
        cv2.fillConvexPoly(want, pts, (9, 8, 7))
        got = raster.fill_convex_poly(np.zeros((h, w, 3), np.uint8),
                                      pts.tolist(), (9, 8, 7))
        assert (got == want).all(), (w, h, pts.tolist())


def test_fill_circle_equals_cv2():
    rng = np.random.default_rng(3)
    for _ in range(2000):
        w, h = int(rng.integers(5, 80)), int(rng.integers(5, 80))
        center = (int(rng.integers(-30, 110)), int(rng.integers(-30, 110)))
        radius = int(rng.integers(0, 30))
        want = np.zeros((h, w, 3), np.uint8)
        cv2.circle(want, center, radius, (10, 20, 30), thickness=-1)
        got = raster.fill_circle(np.zeros((h, w, 3), np.uint8), center,
                                 radius, (10, 20, 30))
        assert (got == want).all(), (w, h, center, radius)


@pytest.mark.parametrize("size", [64, 128, 512])
def test_render_pose_equals_jax(size):
    rng = np.random.default_rng(size)
    for _ in range(40):
        # joints inside the frame, on it and beyond it; one or two people
        kp = rng.uniform(-0.1, 1.1, (int(rng.integers(1, 3)), 18, 2)
                         ).astype(np.float32)
        visible = rng.uniform(0, 1, kp.shape[:2]) > 0.2
        for vis in (visible, None):
            want = j_render_pose(kp, size, size + 16, vis)
            got = render_pose(kp, size, size + 16, vis)
            assert got.dtype == np.uint8 and (got == want).all()


# -------------------------------------------------------------- synthetic --

def test_palettes_and_poses_equal_jax():
    for identity in range(5):
        for seed in (0, 3):
            assert (synthetic.identity_palette(identity, seed)
                    == j_synthetic.identity_palette(identity, seed))
            for pose in range(4):
                np.testing.assert_array_equal(
                    synthetic.sample_pose(identity, pose, seed),
                    j_synthetic.sample_pose(identity, pose, seed))


def _tree(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


@pytest.mark.parametrize("size", [64, 128])
def test_generate_dataset_byte_identical(tmp_path, size):
    got = synthetic.generate_dataset(str(tmp_path / "t"), n_identities=3,
                                     n_poses=5, size=size, seed=1)
    want = j_synthetic.generate_dataset(str(tmp_path / "j"), n_identities=3,
                                        n_poses=5, size=size, seed=1)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    t, j = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert len(t) == 2 + 3 * 3 * 5 and t == j


# ----------------------------------------------------------------- native --

def _native_state():
    return {p.name: (p.stat().st_mtime_ns, p.stat().st_size)
            for p in (ROOT / "native").rglob("*")}


def test_native_equals_jax_and_builds_into_build():
    before = _native_state()
    lib = native.library_path()
    assert lib.parent == ROOT / "build" and "libpcdms_preprocess_" in lib.name
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    other = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for hw in ((64, 48), (20, 30)):
        np.testing.assert_array_equal(native.resize_bicubic(img, *hw),
                                      j_native.resize_bicubic(img, *hw))
    np.testing.assert_array_equal(native.to_neg1_1(img),
                                  j_native.to_neg1_1(img))
    np.testing.assert_array_equal(native.clip_normalize(img),
                                  j_native.clip_normalize(img))
    for right in (other, None):
        np.testing.assert_array_equal(
            native.compose_side_by_side(img, right),
            j_native.compose_side_by_side(img, right))
    kp = rng.uniform(0, 1, (2, 18, 2)).astype(np.float32)
    conf = rng.uniform(0, 1, (2, 18)).astype(np.float32) * (
        rng.uniform(0, 1, (2, 18)) > 0.3)
    for vis in (None, conf):
        np.testing.assert_array_equal(native.render_pose(kp, 64, 48, vis),
                                      j_native.render_pose(kp, 64, 48, vis))
    assert lib.exists() and _native_state() == before


# ---------------------------------------------------------- learning proof --

TINY_BUDGET = ["--identities", "2", "--poses", "4", "--vae_steps", "2",
               "--stage1_steps", "2", "--stage2_steps", "2",
               "--stage3_steps", "2", "--batch_size", "4",
               "--num_inference_steps", "1", "--num_images_per_prompt", "1",
               "--device", "cpu"]


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def test_learning_proof_smoke(tmp_path):
    from pcdms_tpu_torch.cli.learning_proof import main
    root = tmp_path / "lp"
    res = main(["--root", str(root)] + TINY_BUDGET)
    with open(root / "learning_proof.json") as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(res))
    with open(ROOT / "LEARNING_PROOF_r05.json") as f:
        jax_run = json.load(f)
    # the JAX run's keys, and each stage's seconds and the device
    got = _keys(written)
    assert got["config"].pop("device", "missing") is None
    assert written["config"]["device"] == "cpu"
    assert set(got.pop("seconds")) == {
        "vae", "s1_init", "s1", "s1_out_init", "s1_out", "s2_init", "s2",
        "s2_out_init", "s2_out", "s2_out_train", "s3_init", "s3",
        "s3_out_init", "s3_out"}
    assert got == _keys(jax_run)
    # every stage handed its files on: checkpoints, the frozen bundle,
    # stage 1's .npy per test pair, PNGs per pair for stages 2 and 3
    with open(root / "test_pairs.json") as f:
        n_test = len(json.load(f))
    with open(root / "train_pairs.json") as f:
        n_train = len(json.load(f))
    assert (root / "frozen" / "frozen.pt").exists()
    for d in ("s1_init", "s1", "s2_init", "s2", "s3_init", "s3"):
        assert any(p.name.startswith("step_") for p in (root / d).iterdir())
    assert len(list((root / "s1_out").glob("*.npy"))) == n_test
    for d, n in (("s2_out_init", n_test), ("s2_out", n_test),
                 ("s2_out_train", n_train), ("s3_out_init", n_test),
                 ("s3_out", n_test)):
        assert len(list((root / d).glob("*_to_*.png"))) == n, d
    for k in ("stage2_init", "stage2_trained", "stage3_init",
              "stage3_trained"):
        assert all(np.isfinite(v) for v in res[k].values()), k
    assert -1 <= res["stage1_cosine_trained"] <= 1


@pytest.mark.slow
def test_learning_proof_quick_learns(tmp_path):
    from pcdms_tpu_torch.cli.learning_proof import main
    main(["--root", str(tmp_path / "lp"), "--quick", "--assert_improves",
          "--device", "cpu"])
