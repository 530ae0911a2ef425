from pcdms_tpu_torch.serve.engine import (
    DynamicBatcher, EngineClosed, EngineStats, InferenceEngine,
)
from pcdms_tpu_torch.serve.router import ShapeRouter
from pcdms_tpu_torch.serve.stage2 import CascadeService, Stage2Service
