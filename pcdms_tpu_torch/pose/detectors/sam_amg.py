"""SAM's automatic mask generation and the detector facade (counterpart of
``pcdms_tpu/pose/detectors/sam_amg.py``).

controlnet-aux's ``automatic_mask_generator.py``, ``predictor.py``,
``utils/amg.py`` and ``__init__.py``, as the JAX package runs them: the
image's long side resized to the model's 1024 input by PIL's bilinear on
uint8 and pasted into a zero canvas (normalised after the pad), a 32 x 32
point grid prompted in batches of 64; the masks whose predicted IoU >
0.88 taken up to the input by f32 ``INTER_LINEAR``, cropped and resized to
the image (all of a batch's in one call on the device), kept where their
stability score (at +-1.0 logits, counted in int64) >= 0.95, binarised at
0, boxed with inclusive edges, then box NMS at 0.7
within a crop and, with crop layers, across crops (each mask scored by
1 / its crop's area). ``SamDetector`` paints the kept masks, largest
first, each a colour drawn from numpy's global generator, as the reference
does. The networks run on the device in f32 (TF32 off); the decisions and
the bookkeeping on the host in numpy, as the JAX package takes them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pcdms_tpu_torch.pose import imgproc
from pcdms_tpu_torch.pose.detectors.common import (
    as_image, hwc3, resize_to_64, shape_to_64,
)
from pcdms_tpu_torch.pose.detectors.sam import (
    Sam, load_sam, sam_encode_image, sam_predict_points,
)

MASK_THRESHOLD = 0.0
# masks resized at once on the CPU (a batch's 192 at 1024^2 would take
# gigabytes of f64 temporaries there); on a card the whole batch
CPU_RESIZE_CHUNK = 16


def build_point_grid(n_per_side: int) -> np.ndarray:
    offset = 1 / (2 * n_per_side)
    one = np.linspace(offset, 1 - offset, n_per_side)
    xs = np.tile(one[None, :], (n_per_side, 1))
    ys = np.tile(one[:, None], (1, n_per_side))
    return np.stack([xs, ys], axis=-1).reshape(-1, 2)


def generate_crop_boxes(im_size, n_layers: int, overlap_ratio: float):
    crop_boxes, layer_idxs = [[0, 0, im_size[1], im_size[0]]], [0]
    im_h, im_w = im_size
    short_side = min(im_h, im_w)

    def crop_len(orig, n, overlap):
        return int(math.ceil((overlap * (n - 1) + orig) / n))

    for layer in range(n_layers):
        n_crops = 2 ** (layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_crops))
        cw = crop_len(im_w, n_crops, overlap)
        ch = crop_len(im_h, n_crops, overlap)
        x0s = [int((cw - overlap) * i) for i in range(n_crops)]
        y0s = [int((ch - overlap) * i) for i in range(n_crops)]
        for x0 in x0s:
            for y0 in y0s:
                crop_boxes.append([x0, y0, min(x0 + cw, im_w),
                                   min(y0 + ch, im_h)])
                layer_idxs.append(layer + 1)
    return crop_boxes, layer_idxs


def calculate_stability_score(masks: torch.Tensor, thresh: float,
                              offset: float) -> torch.Tensor:
    """(N, H, W) logits -> (N,) f64: the pixels above ``thresh + offset``
    over those above ``thresh - offset``, counted in int64."""
    inter = (masks > (thresh + offset)).sum((-2, -1), dtype=torch.int64)
    union = (masks > (thresh - offset)).sum((-2, -1), dtype=torch.int64)
    return inter.double() / union.clamp(min=1).double()


def batched_mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool -> (N, 4) f32 xyxy with inclusive edges (the first
    and last rows and columns that hold a pixel); an empty mask gets
    [0, 0, 0, 0]."""
    n, h, w = masks.shape
    rows, cols = masks.any(2), masks.any(1)
    iy = torch.arange(h, device=masks.device)
    ix = torch.arange(w, device=masks.device)
    boxes = torch.stack([
        torch.where(cols, ix, w).amin(1), torch.where(rows, iy, h).amin(1),
        torch.where(cols, ix, -1).amax(1), torch.where(rows, iy, -1).amax(1)],
        1)
    return torch.where(rows.any(1)[:, None], boxes, 0).float()


def box_nms(boxes: np.ndarray, scores: np.ndarray,
            iou_thresh: float) -> List[int]:
    order = np.argsort(-scores, kind="stable")
    keep: List[int] = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        x1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        y1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        x2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        y2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(0, x2 - x1) * np.maximum(0, y2 - y1)
        a_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a_r = ((boxes[rest, 2] - boxes[rest, 0])
               * (boxes[rest, 3] - boxes[rest, 1]))
        iou = inter / np.maximum(a_i + a_r - inter, 1e-9)
        order = rest[iou <= iou_thresh]
    return keep


def is_box_near_crop_edge(boxes, crop_box, orig_box,
                          atol: float = 20.0) -> np.ndarray:
    cb = np.asarray(crop_box, np.float32)
    ob = np.asarray(orig_box, np.float32)
    offset = np.array([crop_box[0], crop_box[1], crop_box[0], crop_box[1]],
                      np.float32)
    uncropped = boxes + offset
    near_crop = np.isclose(uncropped, cb[None], atol=atol, rtol=0)
    near_img = np.isclose(uncropped, ob[None], atol=atol, rtol=0)
    return np.any(near_crop & ~near_img, axis=1)


def preprocess_shape(h: int, w: int, long_side: int) -> Tuple[int, int]:
    scale = long_side / max(h, w)
    return (int(h * scale + 0.5), int(w * scale + 0.5))


def postprocess_masks(low: torch.Tensor, size: int, input_hw, orig_hw
                      ) -> torch.Tensor:
    """Low-res logits (N, s, s) -> (N, H, W) at the image's size: f32
    ``INTER_LINEAR`` up to the model's ``size`` input, cropped to the
    resized image (``input_hw``), then to ``orig_hw``; the masks go through
    ``imgproc.resize`` as the channels of one image. Each mask's result
    depends on it alone."""
    (nh, nw), (h, w) = input_hw, orig_hw
    flat = low.permute(1, 2, 0)
    step = max(1, flat.shape[2] if flat.is_cuda else CPU_RESIZE_CHUNK)
    out = [torch.empty(h, w, 0, device=low.device)]
    for i in range(0, flat.shape[2], step):
        up = imgproc.resize(flat[..., i:i + step].contiguous(), (size, size),
                            "linear")[:nh, :nw]
        out.append(imgproc.resize(up.contiguous(), (w, h), "linear"))
    return torch.cat(out, 2).permute(2, 0, 1)


class SamAutomaticMaskGenerator:
    """Grid-prompted whole-image mask generation over the port's ``Sam``
    (folded and moved to ``device``, None: CUDA). ``counts`` holds, after
    each ``generate``, the masks predicted and those left after each
    filter, summed over the crops."""

    def __init__(self, model: Sam, points_per_side: int = 32,
                 points_per_batch: int = 64,
                 pred_iou_thresh: float = 0.88,
                 stability_score_thresh: float = 0.95,
                 stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7,
                 crop_n_layers: int = 0, crop_nms_thresh: float = 0.7,
                 crop_overlap_ratio: float = 512 / 1500,
                 crop_n_points_downscale_factor: int = 1, device=None):
        from pcdms_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.model = model.fold().to(self.device).eval()
        self.cfg = model.cfg
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.point_grids = [
            build_point_grid(
                int(points_per_side / crop_n_points_downscale_factor ** i))
            for i in range(crop_n_layers + 1)]
        self.counts: Dict[str, int] = {}

    # -- the networks (f32, TF32 off) ----------------------------------------

    @torch.no_grad()
    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        from pcdms_tpu_torch.pose.dwpose import f32_forward
        with f32_forward():
            return sam_encode_image(self.model, x)

    @torch.no_grad()
    def _predict(self, emb, coords, labels):
        from pcdms_tpu_torch.pose.dwpose import f32_forward
        with f32_forward():
            return sam_predict_points(self.model, emb, coords, labels,
                                      input_size=self.cfg.img_size)

    # -- predictor internals -------------------------------------------------

    def _set_image(self, image: np.ndarray):
        from PIL import Image
        size = self.cfg.img_size
        h, w = image.shape[:2]
        nh, nw = preprocess_shape(h, w, size)
        resized = np.asarray(Image.fromarray(image).resize(
            (nw, nh), Image.BILINEAR))
        padded = np.zeros((size, size, 3), np.float32)
        padded[:nh, :nw] = resized
        x = torch.from_numpy(padded).to(self.device).permute(2, 0, 1)[None]
        self._embedding = self._encode(x)
        self._input_size = (nh, nw)
        self._orig_size = (h, w)

    def _predict_batch(self, points: np.ndarray):
        """points (B, 2) in the image's pixels -> (low-res mask logits
        (B * 3, s, s) on the device, IoU (B * 3,) numpy f32)."""
        h, w = self._orig_size
        nh, nw = self._input_size
        coords = points.astype(np.float32).copy()
        coords[:, 0] *= nw / w
        coords[:, 1] *= nh / h
        low, iou = self._predict(
            self._embedding,
            torch.from_numpy(coords).to(self.device)[:, None, :],
            torch.ones((len(points), 1), device=self.device))
        return (low.reshape(-1, *low.shape[2:]),
                iou.float().cpu().numpy().reshape(-1))

    # -- generation ----------------------------------------------------------

    def _count(self, key: str, n: int) -> None:
        self.counts[key] = self.counts.get(key, 0) + int(n)

    def _process_crop(self, image, crop_box, layer_idx, orig_size):
        x0, y0, x1, y1 = crop_box
        cropped = np.ascontiguousarray(image[y0:y1, x0:x1])
        self._set_image(cropped)
        ch, cw = cropped.shape[:2]
        points_all = self.point_grids[layer_idx] * np.array([cw, ch])
        orig_h, orig_w = orig_size

        recs: List[Dict] = []
        for s in range(0, len(points_all), self.points_per_batch):
            pts = points_all[s:s + self.points_per_batch]
            low, ious = self._predict_batch(pts)
            pts_rep = np.repeat(pts, 3, axis=0)
            self._count("predicted", len(ious))

            # the IoU filter first: only its masks are taken to the image's
            # size (the same masks as resizing all, then filtering)
            keep = ious > self.pred_iou_thresh
            masks = postprocess_masks(
                low[torch.from_numpy(np.nonzero(keep)[0]).to(low.device)],
                self.cfg.img_size, self._input_size, (ch, cw))
            ious, pts_rep = ious[keep], pts_rep[keep]
            self._count("iou", len(ious))
            stability = calculate_stability_score(
                masks, MASK_THRESHOLD, self.stability_score_offset
            ).cpu().numpy()
            keep = stability >= self.stability_score_thresh
            masks = masks[torch.from_numpy(np.nonzero(keep)[0]).to(
                masks.device)] > MASK_THRESHOLD
            ious, pts_rep = ious[keep], pts_rep[keep]
            stability = stability[keep]
            self._count("stability", len(ious))

            boxes = batched_mask_to_box(masks).cpu().numpy()
            edge = is_box_near_crop_edge(boxes, crop_box,
                                         [0, 0, orig_w, orig_h])
            inner = np.nonzero(~edge)[0]
            kept = masks[torch.from_numpy(inner).to(masks.device)].cpu(
            ).numpy()
            self._count("edge", len(inner))
            for j, i in enumerate(inner):
                recs.append({"mask": kept[j], "iou": float(ious[i]),
                             "stability": float(stability[i]),
                             "box": boxes[i], "point": pts_rep[i]})

        if not recs:
            return recs
        keep = box_nms(np.stack([r["box"] for r in recs]),
                       np.array([r["iou"] for r in recs]),
                       self.box_nms_thresh)
        recs = [recs[i] for i in keep]
        self._count("nms", len(recs))
        for r in recs:
            full = np.zeros((orig_h, orig_w), bool)
            full[y0:y1, x0:x1] = r["mask"]
            r["mask"] = full
            r["box"] = r["box"] + np.array([x0, y0, x0, y0], np.float32)
            r["point"] = r["point"] + np.array([x0, y0], np.float32)
            r["crop_box"] = list(crop_box)
        return recs

    def generate(self, image) -> List[Dict]:
        """image: (H, W, 3) uint8 (numpy, or a tensor on any device) -> one
        dict a kept mask, as the reference's ``generate`` with
        ``output_mode="binary_mask"``: segmentation (bool numpy), area,
        bbox (x, y, w, h), predicted_iou, point_coords, stability_score,
        crop_box."""
        if isinstance(image, torch.Tensor):
            image = image.cpu().numpy()
        self.counts = {}
        orig_size = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(
            orig_size, self.crop_n_layers, self.crop_overlap_ratio)
        recs: List[Dict] = []
        for box, layer in zip(crop_boxes, layer_idxs):
            recs.extend(self._process_crop(image, box, layer, orig_size))
        if len(crop_boxes) > 1 and recs:
            # prefer masks from smaller crops (amg scores 1 / box area)
            scores = np.array([1.0 / max(
                (r["crop_box"][2] - r["crop_box"][0])
                * (r["crop_box"][3] - r["crop_box"][1]), 1) for r in recs])
            keep = box_nms(np.stack([r["box"] for r in recs]), scores,
                           self.crop_nms_thresh)
            recs = [recs[i] for i in keep]
        self._count("kept", len(recs))
        anns = []
        for r in recs:
            x0, y0, x1, y1 = r["box"]
            anns.append({
                "segmentation": r["mask"],
                "area": int(r["mask"].sum()),
                "bbox": [float(x0), float(y0), float(x1 - x0),
                         float(y1 - y0)],
                "predicted_iou": r["iou"],
                "point_coords": [r["point"].tolist()],
                "stability_score": r["stability"],
                "crop_box": r.get("crop_box", [0, 0, orig_size[1],
                                               orig_size[0]]),
            })
        return anns


class SamDetector:
    """controlnet-aux's ``SamDetector``: the image's segments, each painted
    a random colour, on ``device`` (None: CUDA)."""

    def __init__(self, model: Sam, device=None, **amg_kwargs):
        self.mask_generator = SamAutomaticMaskGenerator(
            model, device=device, **amg_kwargs)
        self.device = self.mask_generator.device

    @classmethod
    def from_pretrained(cls, weights_path: str, device=None,
                        **amg_kwargs) -> "SamDetector":
        """From ``sam_vit_{h,l,b}_*.pth`` or ``mobile_sam.pt``, the
        configuration inferred from its keys (unpickled: trusted local files
        only)."""
        return cls(load_sam(weights_path), device, **amg_kwargs)

    @staticmethod
    def show_anns(anns: List[Dict]) -> Optional[np.ndarray]:
        """The masks painted largest first (a stable sort), each in
        ``np.random.randint(255, size=3, dtype=np.uint8)``: one
        ``np.random.seed`` before the call fixes the colours."""
        if len(anns) == 0:
            return None
        anns = sorted(anns, key=lambda a: a["area"], reverse=True)
        h, w = anns[0]["segmentation"].shape
        canvas = np.zeros((h, w, 3), np.uint8)
        for ann in anns:
            color = np.random.randint(255, size=3, dtype=np.uint8)
            canvas[ann["segmentation"]] = color
        return canvas

    def __call__(self, input_image, detect_resolution: int = 512,
                 image_resolution: int = 512) -> np.ndarray:
        img = hwc3(as_image(input_image, self.device))
        img = resize_to_64(img, detect_resolution)
        canvas = self.show_anns(self.mask_generator.generate(img))
        if canvas is None:
            canvas = np.zeros(img.shape, np.uint8)
        detected = hwc3(torch.from_numpy(canvas).to(self.device))
        out_hw = shape_to_64(*img.shape[:2], image_resolution)
        return imgproc.resize(detected, (out_hw[1], out_hw[0]),
                              "linear").cpu().numpy()
