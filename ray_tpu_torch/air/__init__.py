"""The dict form of the reference's `ray_tpu.air.Checkpoint`, kept by
the port (which imports no `ray_tpu`)."""

from ray_tpu_torch.air.checkpoint import Checkpoint  # noqa: F401
