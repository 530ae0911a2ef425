"""The annotator networks as ``nn.Module``s with their published key names:
the DWPose pair (YOLOX-l, ``yolox.py``; RTMPose-l / DWPose-l,
``rtmpose.py``), the OpenPose body / hand / face CPMs (``openpose.py``,
decoded by ``openpose_decode.py``), HED (``hed.py``), PiDiNet (``pidi.py``),
LineArt (``lineart.py``), LineArt-Anime (``lineart_anime.py``), M-LSD
(``mlsd.py``), MiDaS (``midas.py``), NormalBAE (``normalbae.py``),
ZoeDepth (``zoe.py``), LeReS with its boost (``leres.py``,
``leres_boost.py``) and SAM (``sam.py``, MobileSAM's TinyViT in
``tiny_vit.py``, the automatic mask generator in ``sam_amg.py``), each
family's detector with controlnet-aux's call protocol."""

from pcdms_tpu_torch.pose.detectors.hed import (
    ControlNetHED, HEDdetector,
)
from pcdms_tpu_torch.pose.detectors.leres import (
    LeresDetector, RelDepthModel,
)
from pcdms_tpu_torch.pose.detectors.leres_boost import (
    estimateboost, pix2pix4depth,
)
from pcdms_tpu_torch.pose.detectors.lineart import (
    Generator, LineartDetector,
)
from pcdms_tpu_torch.pose.detectors.lineart_anime import (
    LineartAnimeDetector, UnetGenerator,
)
from pcdms_tpu_torch.pose.detectors.midas import DPTHybrid, MidasDetector
from pcdms_tpu_torch.pose.detectors.mlsd import (
    MLSDdetector, MobileV2_MLSD_Large, decode_lines,
)
from pcdms_tpu_torch.pose.detectors.normalbae import NNET, NormalBaeDetector
from pcdms_tpu_torch.pose.detectors.openpose import (
    BodyPoseModel, FaceNet, HandPoseModel, OpenposeDetector,
)
from pcdms_tpu_torch.pose.detectors.pidi import (
    PiDiNet, PidiNetDetector, pdc_transform,
)
from pcdms_tpu_torch.pose.detectors.rtmpose import RTMPose
from pcdms_tpu_torch.pose.detectors.sam import (
    SAM_CONFIGS, Sam, SamConfig, dense_pe, embed_points, sam_encode_image,
    sam_predict_points,
)
from pcdms_tpu_torch.pose.detectors.sam_amg import (
    SamAutomaticMaskGenerator, SamDetector,
)
from pcdms_tpu_torch.pose.detectors.tiny_vit import TinyViT
from pcdms_tpu_torch.pose.detectors.yolox import YOLOX
from pcdms_tpu_torch.pose.detectors.zoe import ZoeDepth, ZoeDetector

__all__ = [
    "ControlNetHED", "HEDdetector", "Generator", "LineartDetector",
    "BodyPoseModel", "FaceNet", "HandPoseModel", "OpenposeDetector",
    "PiDiNet", "PidiNetDetector", "pdc_transform", "RTMPose", "YOLOX",
    "LeresDetector", "RelDepthModel", "estimateboost", "pix2pix4depth",
    "LineartAnimeDetector", "UnetGenerator", "DPTHybrid", "MidasDetector",
    "MLSDdetector", "MobileV2_MLSD_Large", "decode_lines", "NNET",
    "NormalBaeDetector", "ZoeDepth", "ZoeDetector", "SAM_CONFIGS", "Sam",
    "SamConfig", "dense_pe", "embed_points", "sam_encode_image",
    "sam_predict_points", "SamAutomaticMaskGenerator", "SamDetector",
    "TinyViT",
]
