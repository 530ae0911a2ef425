"""SAM, part two: ``SamDetector`` end to end (``pcdms_tpu_torch/pose/
detectors/sam_amg.py``) against the JAX ``SamDetector`` from one seeded
file in MobileSAM's published layout, at the true 1024 input; the
configuration that ``from_pretrained`` and ``Processor("sam")`` infer from
a file; ``show_anns``; on the CPU.

Bars: the canvases equal pixel for pixel (the networks agree to about
1e-6, and the decisions on this image lie farther from their thresholds;
``np.random.seed`` before each side draws the same colours), with the same
count of kept masks; the configuration of each published layout, read
without building the model; the published keys the port does not read
(the mask downscaling, TinyViT's head) dropped at load.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from pcdms_tpu.pose import processors as j_proc  # noqa: E402
from pcdms_tpu.pose.detectors import sam_amg as j_amg  # noqa: E402

from pcdms_tpu_torch.pose import processors  # noqa: E402
from pcdms_tpu_torch.pose.detectors import common, sam, sam_amg  # noqa
from pcdms_tpu_torch.pose.detectors.sam_scene import (  # noqa: E402
    published_state_dict, seeded_sam,
)

from _torch_common import one_thread  # noqa: E402
from test_torch_sam import smooth_image  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


# MobileSAM's mask head crafted so that its masks reach past the +-1.0
# stability offsets; the thresholds at the medians of this file's IoUs and
# stability scores on IMG, and boxes that all span the image kept (NMS is
# part one's), so that a dozen masks are painted
MOBILE_GAIN, MOBILE_SHIFT = 40.0, 2.0
AMG_KW = dict(points_per_side=4, pred_iou_thresh=-0.0166,
              stability_score_thresh=0.2, box_nms_thresh=1.0)
IMG = smooth_image(96, 128, 12)


@pytest.fixture(scope="module")
def mobile_sam_file(tmp_path_factory):
    model = seeded_sam(sam.SAM_CONFIGS["vit_t"], 70, gain=MOBILE_GAIN,
                       shift=MOBILE_SHIFT)
    path = str(tmp_path_factory.mktemp("sam") / "mobile_sam.pt")
    torch.save(published_state_dict(model, 71), path)
    return path, model


def test_detector_equals_jax_on_a_mobile_sam_file(mobile_sam_file):
    """detect_resolution 128 (the image resized to 128 x 192, then to the
    1024 x 683 input and its zero pad), 16 points, the canvas resized to
    image_resolution 128."""
    path, _ = mobile_sam_file
    det = sam_amg.SamDetector.from_pretrained(path, device="cpu", **AMG_KW)
    np.random.seed(5)
    got = det(IMG, detect_resolution=128, image_resolution=128)
    jdet = j_amg.SamDetector.from_pretrained(path, **AMG_KW)
    np.random.seed(5)
    want = jdet(IMG, detect_resolution=128, image_resolution=128)
    c = det.mask_generator.counts
    assert c["predicted"] == 48
    assert c["predicted"] > c["iou"] > c["stability"] >= 8, c
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (128, 192, 3)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 4
    np.testing.assert_array_equal(got, want)


def test_published_keys_the_port_does_not_read_are_dropped(mobile_sam_file):
    path, model = mobile_sam_file
    loaded = sam.load_sam(path)
    assert loaded.cfg == sam.SAM_CONFIGS["vit_t"]
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    keys = set(torch.load(path, weights_only=True))
    assert {"image_encoder.head.weight",
            "prompt_encoder.mask_downscaling.0.weight"} <= keys
    assert keys - set(loaded.state_dict()) == {
        k for k in keys if k.startswith(("image_encoder.head.",
                                         "image_encoder.norm_head.",
                                         "prompt_encoder.mask_downscaling."))}


class _Built(Exception):
    pass


@pytest.mark.parametrize("name", ["vit_h", "vit_l", "vit_b", "vit_t"])
def test_processor_builds_the_files_configuration(name, tmp_path,
                                                  monkeypatch):
    """``Processor("sam", {"weights": f})`` reads the configuration off the
    file's keys (the patch embed's width, or TinyViT's first key) and
    builds that model; here the build is stopped, so no vit_h is made on
    the CPU."""
    key = ("image_encoder.layers.0.blocks.0.conv1.c.weight" if name == "vit_t"
           else "image_encoder.patch_embed.proj.weight")
    shape = ((256, 64, 1, 1) if name == "vit_t"
             else (sam.SAM_CONFIGS[name].dim, 3, 16, 16))
    path = str(tmp_path / "w.pth")
    torch.save({key: torch.zeros(shape)}, path)

    def stop(cls, *args):
        raise _Built(args)
    monkeypatch.setattr(common, "empty", stop)
    with pytest.raises(_Built) as built:
        processors.Processor("sam", {"weights": path}, device="cpu")
    assert built.value.args[0] == (sam.SAM_CONFIGS[name],)


def test_processor_ports_every_id():
    assert set(processors._IMPLEMENTED_NN) == set(j_proc._IMPLEMENTED_NN)
    with pytest.raises(NotImplementedError, match="needs its pretrained"):
        processors.Processor("sam", device="cpu")


def test_show_anns_equals_jax():
    """Largest first by a stable sort (ties keep their order), a colour per
    mask from numpy's global generator, None without masks."""
    rng = np.random.default_rng(13)
    anns = []
    for area_cells in (40, 10, 40, 25, 10, 60):
        seg = np.zeros((30, 40), bool)
        idx = rng.choice(seg.size, area_cells * 5, replace=False)
        seg.flat[idx] = True
        anns.append({"segmentation": seg, "area": int(seg.sum())})
    np.random.seed(3)
    got = sam_amg.SamDetector.show_anns(anns)
    np.random.seed(3)
    want = j_amg.SamDetector.show_anns(None, anns)
    np.testing.assert_array_equal(got, want)
    assert sam_amg.SamDetector.show_anns([]) is None
