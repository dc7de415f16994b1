"""The port's training fabric: the CUDA backend that a caller binds to
the reference's trainer (ray_tpu_torch/train/backend.py), and the MPMD
pipeline — the stage quartet from torch functions, the schedule pump and
the stage gangs (pipeline_trainer.py, pipeline_stage.py)."""

from ray_tpu_torch.train.backend import CudaBackend, CudaConfig  # noqa: F401
from ray_tpu_torch.train.pipeline_stage import (  # noqa: F401
    PipelineStageActor, StageGroup)
from ray_tpu_torch.train.pipeline_trainer import (  # noqa: F401
    PipelineTrainer, torch_stage_fns)
