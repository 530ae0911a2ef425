"""DWPose: person detection and wholebody keypoints (counterpart of
``pcdms_tpu/pose/dwpose.py``).

The reference extracts poses with mmdet YOLOX-l and mmpose DWPose-l
(controlnet_aux's ``dwpose/wholebody.py``, ``single_extract_pose.py``).
``DWposeTorch`` runs the two networks (``pose/detectors/``) on the card, or
on the CPU when asked, in f32 with TF32 off for the convs and the matmuls;
``DWposeDetector`` runs their ONNX exports through onnxruntime and refuses
at construction when onnxruntime is missing. Both share this module's
protocol code and ``__call__``, which remaps COCO-17 to OpenPose-18 with a
synthesised neck (``pose/keypoints.py``) and renders the skeleton with the
hands (``pose/skeleton.py``).

Detection protocol (YOLOX-l, 640x640 letterbox):
  * BGR input, letterbox-resized with ratio r, padded with 114, no
    normalisation
  * outputs decoded with per-level strides (8, 16, 32), NMS at 0.45 IoU,
    score threshold 0.3, person class only
Pose protocol (DWPose / RTMPose-l 384x288 top-down, SimCC):
  * crop each person box expanded 1.25x, affine-resize to 288x384
  * SimCC x / y logits -> argmax / 2.0 (simcc_split_ratio)

The letterbox and the crop are ``pose/imgproc.py``'s, OpenCV's pixels
without cv2, on the device that holds the image.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from pcdms_tpu_torch.compat.load import load_into
from pcdms_tpu_torch.eval import f32_convs
from pcdms_tpu_torch.pose import imgproc
from pcdms_tpu_torch.pose.detectors.common import (
    fold_bn, load_torch_state_dict,
)
from pcdms_tpu_torch.pose.detectors.rtmpose import RTMPose
from pcdms_tpu_torch.pose.detectors.yolox import YOLOX
from pcdms_tpu_torch.pose.keypoints import coco_to_openpose
from pcdms_tpu_torch.pose.skeleton import render_pose
from pcdms_tpu_torch.utils.device import resolve_device


def _require_ort():
    try:
        import onnxruntime
        return onnxruntime
    except ImportError as e:
        raise ImportError(
            "DWposeDetector needs onnxruntime + local ONNX exports of "
            "YOLOX-l and DWPose-l. Use DWposeTorch with the mm checkpoints, "
            "or precompute keypoint .txt files offline "
            "(pcdms_tpu_torch.pose.keypoints.write_pose_txt).") from e


def _image(image, device=None) -> torch.Tensor:
    """An (H, W, 3) uint8 image (array or tensor) as a tensor on ``device``
    (None: where it is; an array goes to the CPU)."""
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.array(image, np.uint8))
    return image if device is None else image.to(device)


def _letterbox(img, size: int = 640):
    """-> (the (size, size, 3) uint8 canvas on the image's device, ratio)."""
    img = _image(img)
    h, w = img.shape[:2]
    r = min(size / h, size / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    canvas = torch.full((size, size, 3), 114, dtype=torch.uint8,
                        device=img.device)
    canvas[:nh, :nw] = imgproc.resize_linear(img, (nw, nh))
    return canvas, r


def _nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float = 0.45):
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        xx1 = np.maximum(boxes[i, 0], boxes[order[1:], 0])
        yy1 = np.maximum(boxes[i, 1], boxes[order[1:], 1])
        xx2 = np.minimum(boxes[i, 2], boxes[order[1:], 2])
        yy2 = np.minimum(boxes[i, 3], boxes[order[1:], 3])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_o = ((boxes[order[1:], 2] - boxes[order[1:], 0])
                  * (boxes[order[1:], 3] - boxes[order[1:], 1]))
        iou = inter / np.maximum(area_i + area_o - inter, 1e-9)
        order = order[1:][iou <= iou_thresh]
    return keep


def decode_yolox(outputs: np.ndarray, ratio: float, input_size: int = 640,
                 score_thresh: float = 0.3):
    """Decode raw YOLOX head outputs (1, N, 85) -> person boxes xyxy."""
    strides = [8, 16, 32]
    grids, expanded = [], []
    for s in strides:
        n = input_size // s
        ys, xs = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        grids.append(np.stack([xs, ys], -1).reshape(-1, 2))
        expanded.append(np.full((n * n, 1), s, np.float32))
    grid = np.concatenate(grids, 0).astype(np.float32)
    stride = np.concatenate(expanded, 0)

    preds = outputs[0].astype(np.float32)
    xy = (preds[:, :2] + grid) * stride
    wh = np.exp(preds[:, 2:4]) * stride
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
    scores = preds[:, 4] * preds[:, 5]          # objectness * person prob
    mask = scores > score_thresh
    boxes, scores = boxes[mask] / ratio, scores[mask]
    if len(boxes) == 0:
        return boxes, scores
    keep = _nms(boxes, scores)
    return boxes[keep], scores[keep]


def _bbox_to_center_scale(box, aspect: float = 288 / 384, padding=1.25):
    x1, y1, x2, y2 = box
    w, h = x2 - x1, y2 - y1
    cx, cy = x1 + w / 2, y1 + h / 2
    if w > aspect * h:
        h = w / aspect
    else:
        w = h * aspect
    return np.array([cx, cy]), np.array([w, h]) * padding


def _pose_crop(image_rgb, box):
    """Expanded-box affine crop to the 288x384 top-down input -> (the crop
    on the image's device, the (2, 3) map)."""
    center, scale = _bbox_to_center_scale(box)
    w, h = 288, 384
    src = np.array([center - scale / 2,
                    center + np.array([scale[0], -scale[1]]) / 2,
                    center + scale / 2], np.float32)
    dst = np.array([[0, 0], [w, 0], [w, h]], np.float32)
    mat = imgproc.get_affine_transform(src, dst)
    return imgproc.warp_affine_linear(_image(image_rgb), mat, (w, h)), mat


def _simcc_to_image(simcc_x: np.ndarray, simcc_y: np.ndarray, mat):
    """SimCC argmax / split-ratio decode + inverse-affine to image coords.
    simcc_x: (K, Wbins), simcc_y: (K, Hbins)."""
    kx = simcc_x.argmax(-1) / 2.0
    ky = simcc_y.argmax(-1) / 2.0
    scores = np.minimum(simcc_x.max(-1), simcc_y.max(-1))
    pts = np.stack([kx, ky], -1)
    inv = imgproc.invert_affine_transform(np.asarray(mat))
    pts = pts @ inv[:, :2].T + inv[:, 2]
    return pts, scores


@contextlib.contextmanager
def f32_forward():
    """The networks' precision policy, as the JAX package runs them: full
    f32 for the convs (``f32_convs``) and for the matmuls (RTMPose's
    linears and GAU products) inside the block, whatever the caller set;
    the caller's settings are restored after it. Process-global, so not
    thread-safe, as ``f32_convs`` states."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with f32_convs():
            yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _nchw(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 -> (1, 3, H, W) f32."""
    return image.permute(2, 0, 1)[None].float()


class DWposeDetector:
    """Reference-compatible facade: detector(image) -> skeleton render +
    keypoints (controlnet_aux's ``dwpose/__init__.py``), on the ONNX
    exports through onnxruntime."""

    det_size = 640          # YOLOX letterbox edge (wholebody protocol)

    def __init__(self, det_onnx: str, pose_onnx: str,
                 providers: Optional[List[str]] = None):
        ort = _require_ort()
        providers = providers or ["CPUExecutionProvider"]
        self.det = ort.InferenceSession(det_onnx, providers=providers)
        self.pose = ort.InferenceSession(pose_onnx, providers=providers)

    def detect_persons(self, image_rgb):
        inp, ratio = _letterbox(imgproc.swap_rb(_image(image_rgb)),
                                self.det_size)
        blob = _nchw(inp).cpu().numpy()
        out = self.det.run(None, {self.det.get_inputs()[0].name: blob})[0]
        return decode_yolox(out, ratio, input_size=self.det_size)

    def estimate_pose(self, image_rgb, box):
        crop, mat = _pose_crop(image_rgb, box)
        blob = _nchw(crop).cpu().numpy()
        simcc_x, simcc_y = self.pose.run(
            None, {self.pose.get_inputs()[0].name: blob})[:2]
        return _simcc_to_image(simcc_x[0], simcc_y[0], mat)

    def __call__(self, image_rgb,
                 render_size: Optional[Tuple[int, int]] = None):
        """image_rgb: (H, W, 3) uint8. Returns (skeleton_render,
        openpose_kpts (N, 18, 2) normalized, scores (N, 18)). The render
        includes the 21-point hand skeletons like the reference's
        draw_pose (body + hands, face disabled); low-score hand points are
        masked to -1 (the reference's un_visible)."""
        h, w = image_rgb.shape[:2]
        boxes, _ = self.detect_persons(image_rgb)
        all_k, all_s, hands = [], [], []
        for box in boxes:
            pts, scores = self.estimate_pose(image_rgb, box)
            all_k.append(pts[:17])
            all_s.append(scores[:17])
            # COCO-wholebody 133 layout: 91:112 left hand, 112:133 right
            norm = pts / np.array([w, h], np.float32)
            for lo, hi in ((91, 112), (112, 133)):
                if pts.shape[0] >= hi:
                    hk = norm[lo:hi].copy()
                    hk[scores[lo:hi] < 0.3] = -1.0
                    hands.append(hk)
        if not all_k:
            kpts = np.zeros((0, 18, 2), np.float32)
            scores18 = np.zeros((0, 18), np.float32)
        else:
            k = np.stack(all_k) / np.array([w, h], np.float32)
            kpts, scores18 = coco_to_openpose(k, np.stack(all_s))
        rh, rw = render_size or (h, w)
        render = render_pose(kpts, rh, rw, visible=scores18 > 0.3,
                             hands=hands)
        return render, kpts, scores18


class DWposeTorch(DWposeDetector):
    """DWPose on the port's networks (the counterpart of the JAX package's
    ``DWposeJAX``): YOLOX-l and RTMPose-l with every BatchNorm folded into
    its conv once, here at construction, on ``device`` (None: CUDA), in f32
    with TF32 off (``f32_forward``). The image goes to the device once a call;
    the letterbox and the crops are made there, the decode, NMS and SimCC
    argmax read the outputs on the host."""

    def __init__(self, det_model, pose_model, det_size: int = 640,
                 device=None):
        self.device = resolve_device(device)
        self.det_size = det_size
        self.det = fold_bn(det_model).to(self.device).eval()
        self.pose = fold_bn(pose_model).to(self.device).eval()

    @classmethod
    def from_torch(cls, det_ckpt: str, pose_ckpt: str,
                   device=None) -> "DWposeTorch":
        """From the mm checkpoints the reference downloads (mmdet YOLOX-l,
        mmpose DWPose-l); a key the network lacks is dropped with a log
        line, a missing one raises."""
        models = [load_into(model, {k: torch.from_numpy(v) for k, v in
                                    load_torch_state_dict(path).items()},
                            path)
                  for model, path in ((YOLOX(), det_ckpt),
                                      (RTMPose(), pose_ckpt))]
        return cls(*models, device=device)

    @torch.no_grad()
    def _forward(self, net, image: torch.Tensor):
        with f32_forward():
            return net(_nchw(image))

    def detect_persons(self, image_rgb):
        inp, ratio = _letterbox(
            imgproc.swap_rb(_image(image_rgb, self.device)), self.det_size)
        out = self._forward(self.det, inp)
        return decode_yolox(out.cpu().numpy(), ratio,
                            input_size=self.det_size)

    def estimate_pose(self, image_rgb, box):
        crop, mat = _pose_crop(_image(image_rgb, self.device), box)
        simcc_x, simcc_y = self._forward(self.pose, crop)
        return _simcc_to_image(simcc_x[0].cpu().numpy(),
                               simcc_y[0].cpu().numpy(), mat)

    def __call__(self, image_rgb,
                 render_size: Optional[Tuple[int, int]] = None):
        return super().__call__(_image(image_rgb, self.device), render_size)
