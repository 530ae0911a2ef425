"""Auxiliary condition processors: controlnet-aux's ``Processor`` facade
(counterpart of ``pcdms_tpu/pose/processors.py``).

  * the non-network processors on the device's tensors through
    ``pose/imgproc.py`` (no cv2): canny, shuffle (content shuffle),
    scribble (dilated canny), and none / resize (pass-through);
  * ``dwpose`` / ``dwpose_body`` on the port's YOLOX-l + RTMPose-l
    (``params={'det_torch': ..., 'pose_torch': ...}``, mm checkpoints); the
    ONNX route (``det_onnx`` / ``pose_onnx``) refuses without onnxruntime,
    which this port does not need;
  * the network families, once their checkpoint is given as
    ``params={'weights': ...}``: the OpenPose ids (``hand_weights`` /
    ``face_weights`` for hands and faces), HED, PiDiNet, LineArt
    (realistic and coarse, ``coarse_weights``), LineArt-Anime, M-LSD,
    MiDaS (depth and normals), NormalBAE, ZoeDepth and LeReS
    (``depth_leres++`` with ``pix2pix_weights``, the boost's merge
    network) and SAM (``sam``: ViT-H / L / B or MobileSAM, the
    configuration inferred from the file);
  * ``mediapipe_face`` through the external ``mediapipe`` package where it
    can be imported.

API: Processor(processor_id, params, device)(image, to_pil=True); the
processors run on ``device`` (None: CUDA).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from PIL import Image

from pcdms_tpu_torch.pose import imgproc
from pcdms_tpu_torch.pose.detectors.common import as_image
from pcdms_tpu_torch.utils.device import resolve_device

# network processors whose family the port has
_IMPLEMENTED_NN = (
    "hed", "hed_safe", "scribble_hed", "softedge_hed", "softedge_hedsafe",
    "scribble_pidinet", "softedge_pidinet", "softedge_pidsafe",
    "lineart_realistic", "lineart_coarse", "lineart_anime", "mlsd",
    "midas", "depth_midas", "normal_midas", "normal_bae", "depth_zoe",
    "depth_leres", "depth_leres++", "sam",
    "openpose", "openpose_face", "openpose_faceonly", "openpose_full",
    "openpose_hand",
)

# network processors whose family is not ported yet -> the family (none
# left: every id of the JAX facade is ported)
_NOT_PORTED: Dict[str, str] = {}

# controlnet-aux processor.py:59-63 include-flag table
_OPENPOSE_FLAGS = {
    "openpose": (True, False, False),
    "openpose_face": (True, False, True),
    "openpose_faceonly": (False, False, True),
    "openpose_full": (True, True, True),
    "openpose_hand": (False, True, False),
}


def _to_np(img) -> np.ndarray:
    if isinstance(img, Image.Image):
        return np.asarray(img.convert("RGB"))
    if isinstance(img, torch.Tensor):
        return img.cpu().numpy()
    return np.asarray(img)


def canny(img, low_threshold: int = 100, high_threshold: int = 200,
          device=None) -> np.ndarray:
    """``cv2.Canny`` of the image, as 3 equal channels."""
    edges = imgproc.canny(as_image(_to_np(img), resolve_device(device)),
                          low_threshold, high_threshold)
    return torch.stack([edges] * 3, -1).cpu().numpy()


def shuffle(img, seed: int = 0, grid: int = 8, device=None) -> np.ndarray:
    """Content shuffle: a coarse random flow field (numpy's draws from
    ``seed``, bicubic-upsampled) warps the image, destroying its layout and
    keeping its colours (controlnet-aux ShuffleDetector)."""
    arr = as_image(_to_np(img), resolve_device(device))
    h, w = arr.shape[:2]
    rng = np.random.default_rng(seed)
    flow = torch.from_numpy(rng.normal(size=(grid, grid, 2)).astype(
        np.float32)).to(arr.device)
    flow = imgproc.resize(flow, (w, h), "cubic")
    flow = flow * torch.tensor(np.array([w, h], np.float32) / grid,
                               device=arr.device)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=arr.device),
                            torch.arange(w, dtype=torch.float32,
                                         device=arr.device), indexing="ij")
    map_x = torch.clamp(xs + flow[..., 0], 0, w - 1)
    map_y = torch.clamp(ys + flow[..., 1], 0, h - 1)
    return imgproc.remap_linear(arr, map_x, map_y).cpu().numpy()


def scribble_from_edges(img, low_threshold: int = 100,
                        high_threshold: int = 200, dilate: int = 2,
                        device=None) -> np.ndarray:
    """Binary scribble map from canny edges, dilated by a (2 d + 1)^2
    square."""
    edges = imgproc.canny(as_image(_to_np(img), resolve_device(device)),
                          low_threshold, high_threshold)
    if dilate > 0:
        edges = imgproc.dilate(edges, np.ones((dilate * 2 + 1,) * 2,
                                              np.uint8))
    return torch.stack([edges] * 3, -1).cpu().numpy()


def mediapipe_face(img, max_faces: int = 1, min_confidence: float = 0.5):
    """Face landmark annotation through the external ``mediapipe`` package
    (the reference wraps the same pip dependency): FaceMesh on the image,
    its landmark mesh (contours emphasised) rasterised by mediapipe onto a
    black canvas of the same size."""
    import mediapipe as mp

    arr = _to_np(img)
    h, w = arr.shape[:2]
    canvas = np.zeros((h, w, 3), np.uint8)
    face_mesh = mp.solutions.face_mesh
    draw = mp.solutions.drawing_utils
    mesh_spec = draw.DrawingSpec(color=(10, 200, 10), thickness=1,
                                 circle_radius=1)
    contour_spec = draw.DrawingSpec(color=(10, 10, 200), thickness=2,
                                    circle_radius=1)
    with face_mesh.FaceMesh(
            static_image_mode=True, max_num_faces=max_faces,
            refine_landmarks=True,
            min_detection_confidence=min_confidence) as fm:
        results = fm.process(arr)
    if results.multi_face_landmarks:
        for landmarks in results.multi_face_landmarks:
            draw.draw_landmarks(
                canvas, landmarks,
                connections=face_mesh.FACEMESH_TESSELATION,
                landmark_drawing_spec=None,
                connection_drawing_spec=mesh_spec)
            draw.draw_landmarks(
                canvas, landmarks,
                connections=face_mesh.FACEMESH_CONTOURS,
                landmark_drawing_spec=None,
                connection_drawing_spec=contour_spec)
    return canvas


class Processor:
    """controlnet-aux ``Processor``-compatible facade."""

    _CTOR_KEYS = ("det_onnx", "pose_onnx", "det_torch", "pose_torch",
                  "weights", "coarse_weights", "hand_weights",
                  "face_weights", "pix2pix_weights")

    def __init__(self, processor_id: str, params: Optional[Dict] = None,
                 device=None):
        self.processor_id = processor_id
        self.params = params or {}
        self.device = resolve_device(device)
        self._fn = self._resolve(processor_id)

    def _resolve(self, pid: str) -> Callable:
        dev = self.device
        if pid == "canny":
            return lambda img, **kw: canny(img, device=dev, **kw)
        if pid == "shuffle":
            return lambda img, **kw: shuffle(img, device=dev, **kw)
        if pid == "scribble":
            return lambda img, **kw: scribble_from_edges(img, device=dev,
                                                         **kw)
        if pid in ("dwpose", "dwpose_body"):
            from pcdms_tpu_torch.pose.dwpose import DWposeDetector, DWposeTorch
            if "det_torch" in self.params:
                det = DWposeTorch.from_torch(self.params["det_torch"],
                                             self.params["pose_torch"],
                                             device=dev)
            else:
                det = DWposeDetector(self.params["det_onnx"],
                                     self.params["pose_onnx"])

            def run(img):
                render, _, _ = det(_to_np(img))
                return render
            return run
        if pid in ("none", "resize"):
            return _to_np
        if pid == "mediapipe_face":
            import importlib.util
            if importlib.util.find_spec("mediapipe") is None:
                raise NotImplementedError(
                    "processor 'mediapipe_face' requires the external "
                    "'mediapipe' package (the reference wraps the same pip "
                    "dependency); install it to enable this processor")
            return mediapipe_face
        if pid in _NOT_PORTED:
            raise NotImplementedError(
                f"processor '{pid}': the {_NOT_PORTED[pid]} family is not "
                "ported to pcdms_tpu_torch yet")
        if pid in _IMPLEMENTED_NN:
            return self._resolve_nn(pid)
        raise ValueError(f"unknown processor: {pid}")

    def _resolve_nn(self, pid: str) -> Callable:
        """The ported network families (``pose/detectors/``); the
        pretrained checkpoint comes as ``params['weights']``."""
        weights = self.params.get("weights")
        if not weights:
            raise NotImplementedError(
                f"processor '{pid}' is implemented "
                "(pcdms_tpu_torch/pose/detectors/) but needs its pretrained "
                "checkpoint: pass params={'weights': '/path/to/ckpt.pth'}"
                + (" (+ 'coarse_weights')" if pid == "lineart_coarse"
                   else ""))
        from pcdms_tpu_torch.pose import detectors as det
        dev = self.device
        if pid in ("hed", "softedge_hed", "scribble_hed", "hed_safe",
                   "softedge_hedsafe", "softedge_pidinet", "scribble_pidinet",
                   "softedge_pidsafe"):
            cls = (det.PidiNetDetector if pid.endswith(("pidinet", "pidsafe"))
                   else det.HEDdetector)
            d = cls.from_pretrained(weights, device=dev)
            safe = "safe" in pid
            scrib = pid.startswith("scribble")
            return lambda img, **kw: d(img, safe=kw.pop("safe", safe),
                                       scribble=kw.pop("scribble", scrib),
                                       **kw)
        if pid in ("lineart_realistic", "lineart_coarse"):
            d = det.LineartDetector.from_pretrained(
                weights if pid == "lineart_realistic" else None,
                self.params.get("coarse_weights",
                                weights if pid == "lineart_coarse"
                                else None), device=dev)
            return lambda img, **kw: d(
                img, coarse=kw.pop("coarse", pid == "lineart_coarse"), **kw)
        if pid in ("lineart_anime", "mlsd", "normal_bae", "depth_zoe",
                   "sam"):
            cls = {"lineart_anime": det.LineartAnimeDetector,
                   "mlsd": det.MLSDdetector,
                   "normal_bae": det.NormalBaeDetector,
                   "depth_zoe": det.ZoeDetector,
                   "sam": det.SamDetector}[pid]
            d = cls.from_pretrained(weights, device=dev)
            return lambda img, **kw: d(img, **kw)
        if pid in ("depth_leres", "depth_leres++"):
            d = det.LeresDetector.from_pretrained(
                weights, pix2pix_weights=self.params.get("pix2pix_weights"),
                device=dev)
            boost = pid.endswith("++")
            return lambda img, **kw: d(img, boost=kw.pop("boost", boost),
                                       **kw)
        if pid in ("midas", "depth_midas", "normal_midas"):
            d = det.MidasDetector.from_pretrained(weights, device=dev)
            if pid == "normal_midas":
                return lambda img, **kw: d(img, depth_and_normal=True,
                                           **kw)[1]
            return lambda img, **kw: d(img, **kw)
        body, hand, face = _OPENPOSE_FLAGS[pid]
        d = det.OpenposeDetector.from_pretrained(
            weights, self.params.get("hand_weights") if hand else None,
            self.params.get("face_weights") if face else None, device=dev)
        return lambda img, **kw: d(
            img, include_body=kw.pop("include_body", body),
            include_hand=kw.pop("include_hand", hand),
            include_face=kw.pop("include_face", face), **kw)

    def __call__(self, image, to_pil: bool = True):
        out = self._fn(image, **{k: v for k, v in self.params.items()
                                 if k not in self._CTOR_KEYS})
        if to_pil and isinstance(out, np.ndarray):
            return Image.fromarray(out.astype(np.uint8))
        return out
