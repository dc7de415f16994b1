"""ray_tpu_torch.util — the port's own helpers (it imports nothing of
`ray_tpu.util`)."""

from ray_tpu_torch.util.observe import Observer  # noqa: F401
