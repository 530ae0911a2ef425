"""OpenPose detector family: the CMU body / hand / face CPM networks as
``nn.Module``s, NCHW (counterpart of ``pcdms_tpu/pose/detectors/openpose.py``).

  * body: VGG-19 stem + 6 refinement stages with two branches, 38-channel
    part-affinity fields (L1) and 19-channel keypoint heatmaps (L2)
    (controlnet_aux ``open_pose/model.py``:24-141), decoded by
    ``openpose_decode`` (peaks, PAF line integrals, greedy people);
  * hand: single-branch 22-channel CPM (model.py:143-216);
  * face: VGG stem + 6 cascaded 71-channel heatmap stages (``face.py``).

Each network's ``state_dict()`` has controlnet-aux's names
(``model0.conv1_1``, ``model1_1.conv5_1_CPM_L1``, ``model2.Mconv1_stage2``,
FaceNet's flat ``conv1_1``, ...); a released file that stores a name
without its block (``conv1_1.weight``) is mapped by
``common.transfer_state_dict``, as controlnet-aux's ``util.transfer``.

``OpenposeDetector`` keeps the reference's protocol: BGR, /256 - 0.5,
stride-8 right / down padding at value 128, the heatmaps resized back by
``smart_resize`` (area to shrink, Lanczos-4 to enlarge, per channel) on the
card (``pose/imgproc.py``), the decode on the host. The networks run in f32
with TF32 off (``dwpose.f32_forward``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pcdms_tpu_torch.pose import imgproc
from pcdms_tpu_torch.pose.detectors.common import (
    as_image, hwc3, resize_to_64, shape_to_64,
)

# ---------------------------------------------------------------------------
# table-driven conv stacks (name, in, out, ksize); pools are explicit
# ---------------------------------------------------------------------------

_BODY_STEM = [
    ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3), ("pool",),
    ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3), ("pool",),
    ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3),
    ("conv3_3", 256, 256, 3), ("conv3_4", 256, 256, 3), ("pool",),
    ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
    ("conv4_3_CPM", 512, 256, 3), ("conv4_4_CPM", 256, 128, 3),
]


def _body_stage1(branch: str, out_ch: int):
    return [(f"conv5_{i}_CPM_{branch}", 128, 128, 3) for i in (1, 2, 3)] + [
        (f"conv5_4_CPM_{branch}", 128, 512, 1),
        (f"conv5_5_CPM_{branch}", 512, out_ch, 1),
    ]


def _body_stageN(n: int, branch: str, out_ch: int):
    return ([(f"Mconv1_stage{n}_{branch}", 185, 128, 7)]
            + [(f"Mconv{i}_stage{n}_{branch}", 128, 128, 7)
               for i in (2, 3, 4, 5)]
            + [(f"Mconv6_stage{n}_{branch}", 128, 128, 1),
               (f"Mconv7_stage{n}_{branch}", 128, out_ch, 1)])


_VGG_STEM = [
    ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3), ("pool",),
    ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3), ("pool",),
    ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3),
    ("conv3_3", 256, 256, 3), ("conv3_4", 256, 256, 3), ("pool",),
    ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
    ("conv4_3", 512, 512, 3), ("conv4_4", 512, 512, 3),
    ("conv5_1", 512, 512, 3), ("conv5_2", 512, 512, 3),
    ("conv5_3_CPM", 512, 128, 3),
]


def _head(out_ch: int):
    return [("conv6_1_CPM", 128, 512, 1), ("conv6_2_CPM", 512, out_ch, 1)]


def _stageN(n: int, cin: int, out_ch: int):
    return ([(f"Mconv1_stage{n}", cin, 128, 7)]
            + [(f"Mconv{i}_stage{n}", 128, 128, 7) for i in (2, 3, 4, 5)]
            + [(f"Mconv6_stage{n}", 128, 128, 1),
               (f"Mconv7_stage{n}", 128, out_ch, 1)])


def _stack(table, final_relu: bool) -> nn.Sequential:
    """controlnet-aux ``make_layers``: convs under their table names, a
    ReLU after each but the last unless ``final_relu``, 2x2 max pools."""
    layers, convs = [], [r for r in table if r[0] != "pool"]
    for i, row in enumerate(table):
        if row[0] == "pool":
            layers.append((f"pool{i}", nn.MaxPool2d(2, 2)))
            continue
        name, cin, cout, k = row
        layers.append((name, nn.Conv2d(cin, cout, k, 1, (k - 1) // 2)))
        if final_relu or row is not convs[-1]:
            layers.append((f"relu_{name}", nn.ReLU()))
    return nn.Sequential(OrderedDict(layers))


class BodyPoseModel(nn.Module):
    """x: (N, 3, H, W) BGR in [-0.5, 0.5] -> (paf (N, 38, H/8, W/8),
    heatmap (N, 19, H/8, W/8)), the stage-6 outputs.

    Quirk kept: the reference's no_relu_layers names 'Mconv7_stage6_L1'
    twice and never 'Mconv7_stage6_L2', so the final heatmap branch is
    relu'd while every other branch head is linear."""

    def __init__(self):
        super().__init__()
        self.model0 = _stack(_BODY_STEM, final_relu=True)
        for n in range(1, 7):
            for bi, (branch, out_ch) in enumerate((("L1", 38), ("L2", 19))):
                table = (_body_stage1(branch, out_ch) if n == 1
                         else _body_stageN(n, branch, out_ch))
                setattr(self, f"model{n}_{bi + 1}",
                        _stack(table, final_relu=(n == 6 and bi == 1)))

    def forward(self, x):
        feat = self.model0(x)
        out1, out2 = self.model1_1(feat), self.model1_2(feat)
        for n in range(2, 7):
            h = torch.cat([out1, out2, feat], 1)
            out1 = getattr(self, f"model{n}_1")(h)
            out2 = getattr(self, f"model{n}_2")(h)
        return out1, out2


class HandPoseModel(nn.Module):
    """x: (N, 3, H, W) BGR in [-0.5, 0.5] -> (N, 22, H/8, W/8)."""

    def __init__(self):
        super().__init__()
        self.model1_0 = _stack(_VGG_STEM, final_relu=True)
        self.model1_1 = _stack(_head(22), final_relu=False)
        for n in range(2, 7):
            setattr(self, f"model{n}",
                    _stack(_stageN(n, 150, 22), final_relu=False))

    def forward(self, x):
        feat = self.model1_0(x)
        out = self.model1_1(feat)
        for n in range(2, 7):
            out = getattr(self, f"model{n}")(torch.cat([out, feat], 1))
        return out


class FaceNet(nn.Module):
    """x: (N, 3, H, W) BGR in [-0.5, 0.5] -> (N, 71, H/8, W/8), the last
    stage's heatmaps. Its convs are direct attributes (the file's flat
    names); pools and ReLUs are applied in ``forward``."""

    _TABLES = ([(_VGG_STEM, True), (_head(71), False)]
               + [(_stageN(n, 199, 71), False) for n in range(2, 7)])

    def __init__(self):
        super().__init__()
        for table, _ in self._TABLES:
            for row in table:
                if row[0] != "pool":
                    name, cin, cout, k = row
                    setattr(self, name,
                            nn.Conv2d(cin, cout, k, 1, (k - 1) // 2))

    def _run(self, table, x, final_relu: bool):
        convs = [r for r in table if r[0] != "pool"]
        for row in table:
            if row[0] == "pool":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = getattr(self, row[0])(x)
            if final_relu or row is not convs[-1]:
                x = F.relu(x)
        return x

    def forward(self, x):
        (stem, r0), (head, r1) = self._TABLES[:2]
        feat = self._run(stem, x, r0)
        out = self._run(head, feat, r1)
        for table, relu in self._TABLES[2:]:
            out = self._run(table, torch.cat([out, feat], 1), relu)
        return out


# ---------------------------------------------------------------------------
# host-side image protocol (open_pose/util.py:11-60), on the card
# ---------------------------------------------------------------------------

def smart_resize(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Area to shrink / Lanczos-4 to enlarge, by the sum of the two sides
    (util.py:smart_resize; its per-channel loop over maps of more than 3
    channels gives what one call over all channels gives)."""
    ht, wt = int(hw[0]), int(hw[1])
    k = float(ht + wt) / float(sum(x.shape[:2]))
    return imgproc.resize(x, (wt, ht), "area" if k < 1 else "lanczos4")


def smart_resize_k(x: torch.Tensor, fx: float, fy: float) -> torch.Tensor:
    return smart_resize(x, (int(x.shape[0] * fy), int(x.shape[1] * fx)))


def pad_right_down(img: torch.Tensor, stride: int = 8, value: int = 128):
    """Pad H / W up to multiples of ``stride`` on the bottom / right with a
    constant (util.py:padRightDownCorner) -> (padded, (pad_h, pad_w))."""
    h, w = img.shape[:2]
    pd = 0 if h % stride == 0 else stride - h % stride
    pr = 0 if w % stride == 0 else stride - w % stride
    out = F.pad(img.permute(2, 0, 1), (0, pr, 0, pd), value=value)
    return out.permute(1, 2, 0), (pd, pr)


def bilinear_align_corners(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """F.interpolate(mode='bilinear', align_corners=True) on (H, W, C)
    numpy, in f64 as the JAX package computes it: the face heatmap's
    upsample (face.py:342-346)."""
    hs, ws = x.shape[:2]
    ys = np.linspace(0.0, hs - 1.0, h, dtype=np.float64)
    xs = np.linspace(0.0, ws - 1.0, w, dtype=np.float64)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, hs - 1)
    x1 = np.minimum(x0 + 1, ws - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = x[y0][:, x0]
    b = x[y0][:, x1]
    c = x[y1][:, x0]
    d = x[y1][:, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx).astype(x.dtype)


def _nchw(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 BGR -> (1, 3, H, W) f32 in [-0.5, 0.5]."""
    return img.permute(2, 0, 1)[None].float() / 256.0 - 0.5


# ---------------------------------------------------------------------------
# detector (open_pose/__init__.py:70-237)
# ---------------------------------------------------------------------------

class OpenposeDetector:
    """Body (+ hand + face) pose detector with the reference call protocol:
    ``__call__(image, detect_resolution, image_resolution, include_body,
    include_hand, include_face)`` -> the rendered skeleton as an (H, W, 3)
    uint8 array. The decode constants (box 368, stride 8, pad 128,
    thresholds 0.1 / 0.05) follow body.py:345-355 / hand.py:25-29 /
    face.py:88-93. The networks sit on ``device`` (None: CUDA)."""

    BOXSIZE = 368
    STRIDE = 8
    PAD_VALUE = 128

    def __init__(self, body: nn.Module, hand: Optional[nn.Module] = None,
                 face: Optional[nn.Module] = None, device=None):
        from pcdms_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.body, self.hand, self.face = (
            None if m is None else m.to(self.device).eval()
            for m in (body, hand, face))

    @classmethod
    def from_pretrained(cls, body_path: str, hand_path: Optional[str] = None,
                        face_path: Optional[str] = None, device=None
                        ) -> "OpenposeDetector":
        """From controlnet-aux's ``body_pose_model.pth``,
        ``hand_pose_model.pth`` and ``facenet.pth`` (unpickled: trusted
        local files only)."""
        from pcdms_tpu_torch.pose.detectors.common import load_network
        return cls(*(None if path is None else load_network(make(), path)
                     for make, path in ((BodyPoseModel, body_path),
                                        (HandPoseModel, hand_path),
                                        (FaceNet, face_path))),
                   device=device)

    @torch.no_grad()
    def _forward(self, net, img):
        from pcdms_tpu_torch.pose.dwpose import f32_forward
        with f32_forward():
            return net(_nchw(img))

    @staticmethod
    def _hwc(t: torch.Tensor) -> torch.Tensor:
        return t[0].permute(1, 2, 0)

    def _upsampled(self, heat: torch.Tensor, padded_hw, pads):
        """A network's (h/8, w/8, C) map resized x8 and cropped to the
        unpadded input."""
        (ph, pw), (pd, pr) = padded_hw, pads
        return smart_resize_k(heat, float(self.STRIDE),
                              float(self.STRIDE))[:ph - pd, :pw - pr]

    # -- body ---------------------------------------------------------------

    def estimate_body(self, bgr: torch.Tensor, scale_search=(0.5,)):
        """Multi-scale body forward + decode (body.py:42-105) on an
        (H, W, 3) uint8 BGR tensor. Returns a list of ``Person`` in pixel
        coordinates of ``bgr``."""
        from pcdms_tpu_torch.pose.detectors.openpose_decode import (
            assemble_people, find_peaks, people_from_subset,
        )
        h, w = bgr.shape[:2]
        heat_avg = np.zeros((h, w, 19), np.float64)
        paf_avg = np.zeros((h, w, 38), np.float64)
        for s in scale_search:
            scale = s * self.BOXSIZE / h
            resized = smart_resize_k(bgr, scale, scale)
            padded, pads = pad_right_down(resized, self.STRIDE,
                                          self.PAD_VALUE)
            paf, heat = (self._hwc(t) for t in self._forward(self.body,
                                                             padded))
            heat = smart_resize(self._upsampled(heat, padded.shape[:2],
                                                pads), (h, w))
            paf = smart_resize(self._upsampled(paf, padded.shape[:2], pads),
                               (h, w))
            heat_avg += heat.cpu().numpy() / len(scale_search)
            paf_avg += paf.cpu().numpy() / len(scale_search)
        peaks = find_peaks(heat_avg, thresh=0.1)
        candidate, subset = assemble_people(peaks, paf_avg, h)
        return people_from_subset(candidate, subset)

    # -- hands / face (crop protocols: hand.py:22-80, face.py:327-346) ------

    def estimate_hand(self, crop_bgr: torch.Tensor,
                      scale_search=(0.5, 1.0, 1.5, 2.0)) -> np.ndarray:
        """(21, 2) peak pixel coordinates in the crop, [0, 0] = missing."""
        from pcdms_tpu_torch.pose.detectors.openpose_decode import (
            hand_peaks_from_heatmaps,
        )
        hr, wr = crop_bgr.shape[:2]
        wsize = 128
        avg = np.zeros((wsize, wsize, 22), np.float64)
        blurred = imgproc.gaussian_blur(crop_bgr, 0.8)
        for s in scale_search:
            size = int(s * self.BOXSIZE)
            resized = smart_resize(blurred, (size, size))
            padded, pads = pad_right_down(resized, self.STRIDE,
                                          self.PAD_VALUE)
            heat = self._hwc(self._forward(self.hand, padded))
            heat = self._upsampled(heat, padded.shape[:2], pads)
            avg += smart_resize(heat, (wsize, wsize)).cpu().numpy() / len(
                scale_search)
        peaks = hand_peaks_from_heatmaps(avg, thresh=0.05).astype(np.float64)
        # from the 128x128 decode grid back to crop pixels with the
        # reference's int() truncation (hand.py:75-77)
        out = np.zeros_like(peaks)
        out[:, 0] = np.floor(peaks[:, 0] * wr / wsize)
        out[:, 1] = np.floor(peaks[:, 1] * hr / wsize)
        return out

    def estimate_face(self, crop_bgr: torch.Tensor) -> np.ndarray:
        """(N <= 70, 2) landmark pixel coordinates in the crop."""
        from pcdms_tpu_torch.pose.detectors.openpose_decode import (
            face_peaks_from_heatmaps,
        )
        hr, wr = crop_bgr.shape[:2]
        resized = smart_resize(crop_bgr, (384, 384))
        heat = self._hwc(self._forward(self.face, resized)).cpu().numpy()
        heat = bilinear_align_corners(heat, hr, wr)
        return face_peaks_from_heatmaps(heat, thresh=0.05)

    # -- full pipeline --------------------------------------------------------

    def detect_poses(self, rgb, include_hand: bool = False,
                     include_face: bool = False):
        """List[Person] with normalised coordinates (missing = -1), plus
        normalised hand / face landmark arrays when requested."""
        from pcdms_tpu_torch.pose.detectors.openpose_decode import (
            face_box, hand_boxes,
        )
        bgr = imgproc.swap_rb(as_image(rgb, self.device)).contiguous()
        h, w = bgr.shape[:2]
        people = self.estimate_body(bgr)
        for person in people:
            if include_hand and self.hand is not None:
                for x0, y0, ww, is_left in hand_boxes(person, h, w):
                    peaks = self.estimate_hand(bgr[y0:y0 + ww, x0:x0 + ww])
                    peaks[:, 0] = np.where(peaks[:, 0] < 1e-6, -1,
                                           peaks[:, 0] + x0) / float(w)
                    peaks[:, 1] = np.where(peaks[:, 1] < 1e-6, -1,
                                           peaks[:, 1] + y0) / float(h)
                    if is_left:
                        person.left_hand = peaks
                    else:
                        person.right_hand = peaks
            if include_face and self.face is not None:
                box = face_box(person, h, w)
                if box is not None:
                    x0, y0, ww = box
                    peaks = self.estimate_face(bgr[y0:y0 + ww, x0:x0 + ww])
                    if peaks.size:
                        peaks[:, 0] = np.where(peaks[:, 0] < 1e-6, -1,
                                               peaks[:, 0] + x0) / float(w)
                        peaks[:, 1] = np.where(peaks[:, 1] < 1e-6, -1,
                                               peaks[:, 1] + y0) / float(h)
                        person.face = peaks
            # normalise the body joints last (the crops above need pixels)
            kp = person.keypoints.copy()
            kp[:, 0] = np.where(kp[:, 0] < 0, -1, kp[:, 0] / float(w))
            kp[:, 1] = np.where(kp[:, 1] < 0, -1, kp[:, 1] / float(h))
            person.keypoints = kp
        return people

    def __call__(self, input_image, detect_resolution: int = 512,
                 image_resolution: int = 512, include_body: bool = True,
                 include_hand: bool = False, include_face: bool = False,
                 output_type: str = "np"):
        from pcdms_tpu_torch.pose.skeleton import render_pose
        img = hwc3(as_image(input_image, self.device))
        img = resize_to_64(img, detect_resolution)
        h, w = img.shape[:2]

        people = self.detect_poses(img, include_hand, include_face)
        if people:
            kpts = np.stack([p.keypoints for p in people])
            vis = np.stack([p.visible for p in people])
            hands = [x for p in people
                     for x in (p.left_hand, p.right_hand) if x is not None]
            faces = [p.face for p in people if p.face is not None]
            canvas = render_pose(kpts, h, w, vis, hands=hands, faces=faces,
                                 draw_body=include_body)
        else:
            canvas = np.zeros((h, w, 3), np.uint8)

        out_hw = shape_to_64(h, w, image_resolution)
        canvas = imgproc.resize_linear(torch.from_numpy(canvas),
                                       (out_hw[1], out_hw[0])).numpy()
        if output_type == "pil":
            from PIL import Image
            return Image.fromarray(canvas)
        return canvas

