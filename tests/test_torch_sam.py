"""SAM, part one: the networks (``pcdms_tpu_torch/pose/detectors/{sam,
tiny_vit}.py``) at their published widths against the JAX package's, the
weights carried back by ``compat/from_jax.py``, the automatic mask
generator's host functions (``sam_amg.py``) and ``generate`` with the
networks stubbed, on the CPU.

Bars:
* The encoders (vit_h / vit_l / vit_b at their published dim and heads,
  depth 2 with one windowed and one global block, 256 px: the 16 x 16 grid
  pads to two 14-windows a side; TinyViT at 256 px, its stride-2 merges),
  the prompt encoder, ``dense_pe`` and the mask decoder (256-d, multimask
  on and off) against ``sam_encode_image`` / ``embed_points`` /
  ``dense_pe`` / ``mask_decoder_apply`` on the trees the JAX
  ``convert_sam`` makes from the port's seeded ``state_dict()``: atol /
  rtol 5e-4 (f32). ``sam_from_jax`` / ``tiny_vit_from_jax`` give back the
  port's own (folded) weights exactly.
* ``build_point_grid``, ``generate_crop_boxes``,
  ``calculate_stability_score``, ``batched_mask_to_box``, ``box_nms``,
  ``is_box_near_crop_edge`` and the resize shape equal the JAX functions
  on random and edge cases.
* ``SamAutomaticMaskGenerator.generate`` at crop layers 0 and 1, the JAX
  generator's networks replaced by the port's outputs: the same inputs to
  the networks, and every annotation equal (segmentation, area, bbox,
  predicted IoU, point, stability score, crop box), with each filter
  dropping some masks and keeping others.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pcdms_tpu.pose.detectors import sam as j_sam  # noqa: E402
from pcdms_tpu.pose.detectors import sam_amg as j_amg  # noqa: E402

from pcdms_tpu_torch.compat import from_jax  # noqa: E402
from pcdms_tpu_torch.pose.detectors import sam, sam_amg  # noqa: E402
from pcdms_tpu_torch.pose.detectors.sam_scene import seeded_sam  # noqa

from _torch_common import one_thread  # noqa: E402

NET_TOL = dict(atol=5e-4, rtol=5e-4)
SMALL = 256                         # the input: a 16 x 16 grid

# the published widths, depth 2 (block 1 global), the input cut to 256 px
ENCODERS = {
    "vit_h": sam.SamConfig(1280, 2, 16, (1,), SMALL),
    "vit_l": sam.SamConfig(1024, 2, 16, (1,), SMALL),
    "vit_b": sam.SamConfig(768, 2, 12, (1,), SMALL),
    "vit_t": sam.SAM_CONFIGS["vit_t"]._replace(img_size=SMALL),
}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def jax_cfg(cfg):
    return j_sam.SamConfig(*cfg[:5])


def state_dict(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def seeded_pair(name, seed):
    """(the port's seeded model, the JAX tree ``convert_sam`` makes of its
    unfolded state dict)."""
    cfg = ENCODERS[name]
    model = seeded_sam(cfg, seed)
    params, _ = j_sam.convert_sam(state_dict(model), cfg=jax_cfg(cfg))
    return model, params


def smooth_image(h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (max(1, h // 8), max(1, w // 8), 3),
                        dtype=np.uint8)
    return np.asarray(Image.fromarray(base).resize((w, h), Image.BICUBIC))


# ---------------------------------------------------------------------------
# the networks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_matches_jax_and_carries_back(name):
    """As published (TinyViT's BatchNorms at run time), then folded as the
    detector folds it; the JAX tree carried back equals the folded
    weights."""
    model, params = seeded_pair(name, 40 + list(ENCODERS).index(name))
    x = np.random.default_rng(5).uniform(0, 255, (1, SMALL, SMALL, 3)
                                         ).astype(np.float32)
    want = np.asarray(jax.jit(j_sam.sam_encode_image, static_argnames="cfg")(
        params, jnp.asarray(x), cfg=jax_cfg(ENCODERS[name])))
    assert want.shape == (1, 16, 16, 256) and np.isfinite(want).all()
    with torch.no_grad():
        for fold in (False, True):
            if fold:
                model.fold()
            got = sam.sam_encode_image(model, t(x.transpose(0, 3, 1, 2)))
            np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                                       want, **NET_TOL)
    tree = jax.tree.map(np.asarray, params)
    # a ViT's configuration is read off the tree; a TinyViT's input size is
    # not in it
    carried = from_jax.sam_from_jax(
        tree, ENCODERS[name] if name == "vit_t" else None)
    assert carried.cfg == ENCODERS[name]
    mine, back = model.state_dict(), carried.state_dict()
    assert mine.keys() == back.keys()
    for k, v in mine.items():
        assert torch.equal(back[k], v), k
    if name == "vit_t":
        enc = from_jax.tiny_vit_from_jax(tree["encoder"]["tiny"])
        for k, v in model.image_encoder.state_dict().items():
            assert torch.equal(enc.state_dict()[k], v), k


def test_rel_pos_tables_must_fit_the_grid():
    """A global block's tables are sized by the grid (2 * 16 - 1 = 31 rows
    at 256 px): another grid raises, as the JAX package asserts."""
    model = seeded_sam(ENCODERS["vit_b"], 3)
    assert model.image_encoder.blocks[1].attn.rel_pos_h.shape == (31, 64)
    assert model.image_encoder.blocks[0].attn.rel_pos_h.shape == (27, 64)
    with pytest.raises(ValueError, match="never interpolated"):
        model.image_encoder.blocks[1](torch.zeros(1, 32, 32, 768))


@pytest.mark.parametrize("multimask", [True, False])
def test_prompt_encoder_and_decoder_match_jax(multimask):
    """Positive, negative and pad points (the pad point appended), the
    grid's encoding and the two-way decoder at its 256-d width on a 16 x 16
    embedding."""
    model, params = seeded_pair("vit_b", 50)
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((1, 16, 16, 256)).astype(np.float32)
    coords = rng.uniform(0, SMALL, (5, 2, 2)).astype(np.float32)
    labels = np.array([[1, 0], [0, 1], [1, -1], [1, 1], [0, -1]],
                      np.float32)
    want_sparse = np.asarray(j_sam.embed_points(
        params["prompt"], jnp.asarray(coords), jnp.asarray(labels),
        input_size=SMALL))
    want_pe = np.asarray(j_sam.dense_pe(params["prompt"], (16, 16)))
    want_m, want_iou = jax.jit(j_sam.mask_decoder_apply, static_argnames=(
        "multimask",))(params["decoder"], jnp.asarray(emb),
                       jnp.asarray(want_pe), jnp.asarray(want_sparse),
                       multimask=multimask)
    with torch.no_grad():
        sparse = sam.embed_points(model.prompt_encoder, t(coords), t(labels),
                                  input_size=SMALL)
        pe = sam.dense_pe(model.prompt_encoder, (16, 16))
        np.testing.assert_allclose(sparse.numpy(), want_sparse, **NET_TOL)
        np.testing.assert_allclose(pe[0].permute(1, 2, 0).numpy(), want_pe,
                                   **NET_TOL)
        masks, iou = sam.sam_predict_points(
            model, t(emb.transpose(0, 3, 1, 2)), t(coords), t(labels),
            multimask=multimask, input_size=SMALL)
    m = 3 if multimask else 1
    assert masks.shape == (5, m, 64, 64) and iou.shape == (5, m)
    np.testing.assert_allclose(masks.numpy(), np.asarray(want_m), **NET_TOL)
    np.testing.assert_allclose(iou.numpy(), np.asarray(want_iou), **NET_TOL)


def test_sam_config_inferred_from_keys():
    for name in ("vit_h", "vit_l", "vit_b"):
        dim = sam.SAM_CONFIGS[name].dim
        sd = {"image_encoder.patch_embed.proj.weight":
              np.zeros((dim, 3, 16, 16), np.float32)}
        assert sam.sam_config(sd) == sam.SAM_CONFIGS[name]
    sd = {"image_encoder.layers.0.blocks.0.conv1.c.weight": np.zeros(1)}
    assert sam.sam_config(sd) == sam.SAM_CONFIGS["vit_t"]
    for name, cfg in sam.SAM_CONFIGS.items():
        assert tuple(cfg[:5]) == tuple(j_sam.SAM_CONFIGS[name])


# ---------------------------------------------------------------------------
# the host functions
# ---------------------------------------------------------------------------

def test_point_grid_and_crop_boxes_equal_jax():
    for n in (1, 2, 5, 16, 32):
        np.testing.assert_array_equal(sam_amg.build_point_grid(n),
                                      j_amg.build_point_grid(n))
    for size in ((512, 512), (80, 96), (333, 517), (1, 7)):
        for layers in (0, 1, 2):
            for ratio in (512 / 1500, 0.0, 0.5):
                assert (sam_amg.generate_crop_boxes(size, layers, ratio)
                        == j_amg.generate_crop_boxes(size, layers, ratio))


def test_stability_score_equals_jax():
    """Logits exactly at the +-1 offsets and at 0 (strict >), empty masks
    (union 0), f64 ratios."""
    rng = np.random.default_rng(7)
    masks = rng.normal(0, 1.5, (24, 33, 17)).astype(np.float32)
    masks[0] = 1.0
    masks[1] = -1.0
    masks[2] = -5.0
    masks[3, :, :5] = 1.0
    masks[4] = np.where(rng.random((33, 17)) < 0.5, 1.0, 1.0 + 1e-7)
    for thresh, offset in ((0.0, 1.0), (0.0, 0.5), (0.3, 0.0)):
        got = sam_amg.calculate_stability_score(t(masks), thresh, offset)
        want = j_amg.calculate_stability_score(masks, thresh, offset)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), want)


def test_mask_to_box_equals_jax():
    rng = np.random.default_rng(8)
    masks = rng.random((20, 31, 45)) < 0.02
    masks[0] = False                                 # empty
    masks[1] = True                                  # full
    masks[2] = False
    masks[2, 30, 44] = True                          # the last pixel
    masks[3] = False
    masks[3, 0, 0] = True                            # the first
    masks[4] = False
    masks[4, 5:9, 3] = True                          # one column
    got = sam_amg.batched_mask_to_box(t(masks))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), j_amg.batched_mask_to_box(
        masks))


def test_box_nms_equals_jax():
    """Random boxes with tied scores (the stable order decides), nested
    and identical boxes, zero-area boxes, IoU exactly at the threshold."""
    rng = np.random.default_rng(9)
    for case in range(30):
        n = int(rng.integers(1, 40))
        xy = rng.integers(0, 50, (n, 2))
        wh = rng.integers(0, 30, (n, 2))
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        if case % 3 == 0 and n > 2:
            boxes[1] = boxes[0]
        scores = rng.integers(0, 4, n) / 4.0 if case % 2 else rng.random(n)
        for thresh in (0.0, 0.5, 0.7, 1.0):
            assert (sam_amg.box_nms(boxes, scores, thresh)
                    == j_amg.box_nms(boxes, scores, thresh))
    boxes = np.array([[0, 0, 10, 10], [0, 0, 10, 5]], np.float32)
    for thresh in (0.5, np.nextafter(0.5, 0)):       # IoU exactly 0.5
        assert (sam_amg.box_nms(boxes, np.array([1.0, 0.5]), thresh)
                == j_amg.box_nms(boxes, np.array([1.0, 0.5]), thresh))


def test_crop_edge_and_resize_shape_equal_jax():
    """Boxes on a crop's inner edge (dropped), on the image's edge (kept),
    within and just outside the 20 px tolerance."""
    crop, orig = [40, 30, 140, 110], [0, 0, 200, 110]
    boxes = np.array([[0, 0, 50, 50],        # on the crop's left / top
                      [60, 0, 99, 79],       # right edge (140 - 40 - 1)
                      [20, 20, 60, 60],      # inside, 20 px from left
                      [21, 21, 60, 59],      # beyond the tolerance
                      [10, 50, 70, 80],      # bottom: the image's edge
                      [0, 0, 0, 0]], np.float32)
    for crop_box in (crop, [0, 0, 200, 110], [100, 0, 200, 110]):
        np.testing.assert_array_equal(
            sam_amg.is_box_near_crop_edge(boxes, crop_box, orig),
            j_amg.is_box_near_crop_edge(boxes, crop_box, orig))
    for h, w in ((512, 512), (333, 517), (1, 1023), (1025, 3), (77, 91),
                 (480, 640), (640, 479)):
        for side in (1024, 256):
            assert (sam_amg.preprocess_shape(h, w, side)
                    == j_amg._preprocess_shape(h, w, side))


# ---------------------------------------------------------------------------
# generate, the JAX generator's networks replaced by the port's outputs
# ---------------------------------------------------------------------------

# thresholds inside the spread of the seeded model's IoUs and stability
# scores (seeded_sam), so that each filter drops some masks and keeps others
AMG_KW = dict(points_per_side=4, points_per_batch=8, pred_iou_thresh=0.05,
              stability_score_thresh=0.001, box_nms_thresh=0.9,
              crop_nms_thresh=0.3)


@pytest.mark.parametrize("crop_n_layers", [0, 1])
def test_generate_equals_jax_with_the_ports_networks(crop_n_layers):
    cfg = ENCODERS["vit_b"]
    model = seeded_sam(cfg, 60)
    gen = sam_amg.SamAutomaticMaskGenerator(
        model, crop_n_layers=crop_n_layers, device="cpu", **AMG_KW)
    calls = {"encode": [], "predict": []}
    encode, predict = gen._encode, gen._predict

    def rec_encode(x):
        out = encode(x)
        calls["encode"].append((x.numpy(), out.numpy()))
        return out

    def rec_predict(emb, coords, labels):
        low, iou = predict(emb, coords, labels)
        calls["predict"].append((coords.numpy(), labels.numpy(), low.numpy(),
                                 iou.numpy()))
        return low, iou

    gen._encode, gen._predict = rec_encode, rec_predict
    img = smooth_image(80, 96, 11)
    got = gen.generate(img)

    jgen = j_amg.SamAutomaticMaskGenerator(None, jax_cfg(cfg),
                                           crop_n_layers=crop_n_layers,
                                           **AMG_KW)
    seen = {"encode": 0, "predict": 0}

    def j_encode(_params, x, cfg):
        x_port, out = calls["encode"][seen["encode"]]
        seen["encode"] += 1
        np.testing.assert_array_equal(np.asarray(x), x_port.transpose(
            0, 2, 3, 1))
        return out

    def j_predict(_params, _emb, coords, labels, input_size):
        c, lab, low, iou = calls["predict"][seen["predict"]]
        seen["predict"] += 1
        np.testing.assert_array_equal(np.asarray(coords), c)
        np.testing.assert_array_equal(np.asarray(labels), lab)
        assert input_size == SMALL
        return low, iou

    jgen._encode, jgen._predict = j_encode, j_predict
    want = jgen.generate(img)
    n_crops = len(j_amg.generate_crop_boxes(img.shape[:2], crop_n_layers,
                                            512 / 1500)[0])
    assert seen["encode"] == len(calls["encode"]) == n_crops
    assert seen["predict"] == len(calls["predict"]) == 2 * n_crops

    c = gen.counts
    assert c["predicted"] == 48 * n_crops
    assert c["predicted"] > c["iou"] > c["stability"] > 0, c
    assert c["stability"] >= c["edge"] > c["nms"] >= c["kept"] > 0, c
    if crop_n_layers:
        assert c["stability"] > c["edge"] and c["nms"] > c["kept"], c
    assert len(got) == len(want) == c["kept"]
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["segmentation"], b["segmentation"])
        assert a["segmentation"].dtype == b["segmentation"].dtype == bool
        for k in ("area", "bbox", "predicted_iou", "point_coords",
                  "stability_score", "crop_box"):
            assert a[k] == b[k], k
