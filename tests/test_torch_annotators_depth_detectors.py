"""The depth, normal and line annotator families, part two: each detector's
``__call__`` through the ``Processor`` facade (``pcdms_tpu_torch/pose/
processors.py``) against the JAX ``Processor``, on the same image and the
same weight files (the seeded full-width networks saved in their published
layouts), on the CPU; and the refusals.

Bars: the maps equal the JAX package's pixel for pixel, but for the maps
whose last step truncates a network's f32 output to uint8 (LineArt-Anime's
line map, MiDaS's depth and normals, NormalBAE's normals, LeReS's 16-bit
step, ZoeDepth's percentile map): there at most 1 level on at most 0.5 % of
the values (the networks agree to about 1e-6, the truncation flips where a
value lies that close to a level). ZoeDepth runs at a 96x128 net size on
both sides (``prep_size`` cut; the protocol's 384x512 would take minutes
on a CPU), with the JAX ``_log_binomial`` run eagerly (jitted on XLA's CPU it
gives NaN). ``depth_leres++`` runs the boost with the merge network at 6 of
its 10 levels (full widths), a 64 px merge and a 128 px receptive field on
both sides, where its small image takes the whole-image exit (the patch
loop is part one's, with stubs, and the card's).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from PIL import Image

cv2 = pytest.importorskip("cv2")

from pcdms_tpu.pose import processors as j_proc  # noqa: E402
from pcdms_tpu.pose.detectors import leres as j_leres  # noqa: E402
from pcdms_tpu.pose.detectors import leres_boost as j_boost  # noqa: E402
from pcdms_tpu.pose.detectors import lineart_anime as j_anime  # noqa: E402
from pcdms_tpu.pose.detectors import midas as j_midas  # noqa: E402
from pcdms_tpu.pose.detectors import mlsd as j_mlsd  # noqa: E402
from pcdms_tpu.pose.detectors import normalbae as j_nb  # noqa: E402
from pcdms_tpu.pose.detectors import zoe as j_zoe  # noqa: E402

from pcdms_tpu_torch.pose import processors  # noqa: E402
from pcdms_tpu_torch.pose.detectors import leres, leres_boost, zoe  # noqa

from _torch_common import one_thread  # noqa: E402
from test_torch_annotators_depth import (  # noqa: E402
    _eager_log_binomial, seeded, short_pix2pix,
)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _image(h=128, w=96, seed=4):
    """A smooth seeded RGB image with a few sharp bars (lines for M-LSD)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    img[20:24, 10:80] = 255
    img[30:110, 60:63] = 0
    return img


IMG = _image()


@pytest.fixture
def small_protocols(monkeypatch):
    """ZoeDepth's net size and the boost's sizes cut on both sides, the JAX
    ``_log_binomial`` run eagerly."""
    monkeypatch.setattr(j_zoe, "_log_binomial", _eager_log_binomial)
    monkeypatch.setattr(j_zoe, "_prep_size", functools.partial(
        j_zoe._prep_size, net_h=96, net_w=128))
    monkeypatch.setattr(zoe, "prep_size", functools.partial(
        zoe.prep_size, net_h=96, net_w=128))
    short_pix2pix(monkeypatch)
    for mod, names in ((leres_boost, ("PIX2PIX_SIZE", "RECEPTIVE")),
                       (j_boost, ("_PIX2PIX_SIZE", "_RECEPTIVE"))):
        monkeypatch.setattr(mod, names[0], 64)
        monkeypatch.setattr(mod, names[1], 128)


# the published layouts: {file name: (network, wrap the state dict)}
_LAYOUTS = {
    "lineart_anime": ("lineart_anime", lambda sd: sd),
    "mlsd": ("mlsd", lambda sd: sd),
    "midas": ("midas", lambda sd: sd),
    "normalbae": ("normalbae", lambda sd: {"model": sd}),
    "zoe": ("zoe", lambda sd: {"model": sd}),
    "leres": ("leres", lambda sd: {"depth_model": {
        f"module.{k}": v for k, v in sd.items()}}),
    "pix2pix": ("pix2pix", lambda sd: sd),
}


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """Each seeded full-width network saved once in its published layout
    (the merge network at 6 levels); the modules dropped after saving."""
    root = tmp_path_factory.mktemp("depth_annotators")
    files = {}
    with pytest.MonkeyPatch.context() as mp, one_thread():
        short_pix2pix(mp)
        for i, (name, (net, wrap)) in enumerate(_LAYOUTS.items()):
            model, _ = seeded(net, 60 + i)
            files[name] = str(root / f"{name}.pth")
            torch.save(wrap({k: v.clone() for k, v in
                             model.state_dict().items()}), files[name])
            del model
    return files


_JAX_NETS = {}


@pytest.fixture
def shared_jax_jit(monkeypatch):
    """One jitted function per JAX network across the Processor ids (each
    JAX detector jits its network per instance)."""
    for cls, fn in ((j_anime.LineartAnimeDetector,
                     j_anime.lineart_anime_apply),
                    (j_mlsd.MLSDdetector, j_mlsd.mlsd_apply),
                    (j_midas.MidasDetector, j_midas.dpt_hybrid_apply),
                    (j_nb.NormalBaeDetector, j_nb.nnet_apply),
                    (j_zoe.ZoeDetector, j_zoe.zoe_apply),
                    (j_leres.LeresDetector, j_leres.leres_apply)):
        init = cls.__init__

        def shared(self, *a, _init=init, _fn=fn, **k):
            _init(self, *a, **k)
            self._apply = _JAX_NETS.setdefault(_fn, jax.jit(_fn))
        monkeypatch.setattr(cls, "__init__", shared)


# (id, its weight file, its extra params, level bar)
CASES = [
    ("lineart_anime", "lineart_anime", {}, True),
    ("mlsd", "mlsd", {}, False),
    ("mlsd", "mlsd", {"thr_v": 0.6, "thr_d": 4.0}, False),
    ("midas", "midas", {}, True),
    ("depth_midas", "midas", {"image_resolution": 96}, True),
    ("normal_midas", "midas", {"bg_th": 0.3}, True),
    ("normal_bae", "normalbae", {}, True),
    ("depth_zoe", "zoe", {"gamma_corrected": True}, True),
    ("depth_leres", "leres", {}, True),
    ("depth_leres", "leres", {"thr_a": 20, "thr_b": 10}, True),
    ("depth_leres++", "leres", {}, True),
]


@pytest.mark.parametrize("pid,weights,extra,soft", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_processor_ids_equal_jax(pid, weights, extra, soft, weight_files,
                                 shared_jax_jit, small_protocols):
    params = {"weights": weight_files[weights],
              "pix2pix_weights": weight_files["pix2pix"],
              "detect_resolution": 64, "image_resolution": 64, **extra}
    want = j_proc.Processor(pid, dict(params))(IMG, to_pil=False)
    proc = processors.Processor(pid, dict(params), device="cpu")
    got = proc(IMG, to_pil=False)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if soft:
        assert d.max() <= 1 and (d > 0).mean() <= 5e-3, (
            d.max(), (d > 0).mean())
    else:
        np.testing.assert_array_equal(got, want)
    if pid == "mlsd" and not extra:
        assert (want > 0).any()             # the random M-LSD finds lines
        assert isinstance(proc(Image.fromarray(IMG)), Image.Image)


def test_boost_without_merge_network_refuses_as_jax(weight_files):
    det = leres.LeresDetector.from_pretrained(weight_files["leres"],
                                              device="cpu")
    with pytest.raises(NotImplementedError, match="pix2pix merge network"):
        det(IMG, boost=True, detect_resolution=64)
    with pytest.raises(NotImplementedError, match="pix2pix merge network"):
        j_leres.LeresDetector(None)(IMG, boost=True)


NEW_IDS = ["lineart_anime", "mlsd", "midas", "depth_midas", "normal_midas",
           "normal_bae", "depth_zoe", "depth_leres", "depth_leres++"]


@pytest.mark.parametrize("pid", NEW_IDS)
def test_processor_refuses_without_weights_as_jax(pid):
    with pytest.raises(NotImplementedError, match="needs its pretrained"):
        j_proc.Processor(pid)
    with pytest.raises(NotImplementedError, match="needs its pretrained"):
        processors.Processor(pid, device="cpu")


def test_processor_refuses_sam_naming_the_next_item(tmp_path, monkeypatch):
    """The next item (SAM) is ported: no id is left unported, and
    ``Processor("sam", {"weights": f})`` builds the configuration of ``f``'s
    layout (vit_b by its patch embed's width; the build is stopped before
    the model is made)."""
    from pcdms_tpu_torch.pose.detectors import common, sam
    assert processors._NOT_PORTED == {}
    assert set(NEW_IDS) | {"sam"} <= set(processors._IMPLEMENTED_NN)
    path = str(tmp_path / "sam_vit_b.pth")
    torch.save({"image_encoder.patch_embed.proj.weight":
                torch.zeros(768, 3, 16, 16)}, path)
    built = []

    def stop(cls, cfg):
        built.append((cls, cfg))
        raise RuntimeError("stopped")
    monkeypatch.setattr(common, "empty", stop)
    with pytest.raises(RuntimeError, match="stopped"):
        processors.Processor("sam", {"weights": path}, device="cpu")
    assert built == [(sam.Sam, sam.SAM_CONFIGS["vit_b"])]
