"""Models of the port: the GPT and Llama families' training forward and
loss, their train step, and their cached (serving) forward."""

from ray_tpu_torch.models import gpt, llama  # noqa: F401
