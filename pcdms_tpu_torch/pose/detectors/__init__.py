"""The DWPose networks: YOLOX-l (``yolox.py``) and RTMPose-l / DWPose-l
(``rtmpose.py``) as ``nn.Module``s with the mm checkpoints' key names."""
