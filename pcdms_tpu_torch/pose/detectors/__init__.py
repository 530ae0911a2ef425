"""The annotator networks as ``nn.Module``s with their published key names:
the DWPose pair (YOLOX-l, ``yolox.py``; RTMPose-l / DWPose-l,
``rtmpose.py``), the OpenPose body / hand / face CPMs (``openpose.py``,
decoded by ``openpose_decode.py``), HED (``hed.py``), PiDiNet (``pidi.py``)
and LineArt (``lineart.py``), each family's detector with controlnet-aux's
call protocol. The depth, normal, segmentation, anime line-art and M-LSD
families are not ported yet."""

from pcdms_tpu_torch.pose.detectors.hed import (
    ControlNetHED, HEDdetector,
)
from pcdms_tpu_torch.pose.detectors.lineart import (
    Generator, LineartDetector,
)
from pcdms_tpu_torch.pose.detectors.openpose import (
    BodyPoseModel, FaceNet, HandPoseModel, OpenposeDetector,
)
from pcdms_tpu_torch.pose.detectors.pidi import (
    PiDiNet, PidiNetDetector, pdc_transform,
)
from pcdms_tpu_torch.pose.detectors.rtmpose import RTMPose
from pcdms_tpu_torch.pose.detectors.yolox import YOLOX

__all__ = [
    "ControlNetHED", "HEDdetector", "Generator", "LineartDetector",
    "BodyPoseModel", "FaceNet", "HandPoseModel", "OpenposeDetector",
    "PiDiNet", "PidiNetDetector", "pdc_transform", "RTMPose", "YOLOX",
]
