"""The port's training fabric: the CUDA backend that a caller binds to
the reference's trainer (ray_tpu_torch/train/backend.py)."""

from ray_tpu_torch.train.backend import CudaBackend, CudaConfig  # noqa: F401
