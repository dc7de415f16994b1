"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A second package beside `ray_tpu/` (the JAX reference, which it never
imports).  It mirrors the reference's layout so each module has an
obvious counterpart: `ray_tpu_torch/ops/attention.py` <->
`ray_tpu/ops/attention.py`, and so on.  Plain tensor code is PyTorch;
each Pallas kernel of the reference becomes a kernel written by hand for
Hopper (`ops/csrc/`), built with nvcc at first use.

Ported so far — the serving path: the paged-KV cache, the
continuous-batching engine with in-step sampling (token-exact with the
reference's threefry draws), the cached forward of the GPT and Llama
families, and the single-query paged-decode attention kernel (GQA
included); and the single-device training path of both families: the
training forward and loss, flash attention forward and backward
kernels, the fused chunked cross-entropy and AdamW
(`models.gpt.make_train_step`, `models.llama.make_train_step`).  On the
serving side also speculative decoding, behaviour log-probs, the KV
spill tier, prefix export and import with their frame codec, and the
serve deployments (`ray_tpu_torch.serve`: plain classes that a caller
binds with the reference's serve plane).  On the training side also
GPT's Switch MoE on one device, ResNet (`models.resnet`), and the
training fabric: sharded asynchronous checkpoints in the reference's
format (`ray_tpu_torch.checkpoint`), the device feed
(`ray_tpu_torch.data`) and a CUDA backend that a caller binds to the
reference's trainer (`ray_tpu_torch.train`).  And the RL path
(`ray_tpu_torch.rllib`, `ray_tpu_torch.rl`): V-trace, the actor-critics,
rollout workers, PPO and IMPALA learners, engine rollouts with behaviour
log-probs and the Podracer loop, with the runtime passed in as a handle.

Every entry point takes `device=None`, which means CUDA; without a card
it raises unless the caller passes `device="cpu"`.
"""

from ray_tpu_torch._device import resolve_device  # noqa: F401
from ray_tpu_torch.models import gpt, llama  # noqa: F401
