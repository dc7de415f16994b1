"""Ops of the port: attention with hand-written Hopper kernels (flash
attention forward and backward, paged decode, paged prefill) and the
fused chunked cross-entropy."""

from ray_tpu_torch.ops.attention import (  # noqa: F401
    NEG_INF, flash_attention, flash_backward_plain, flash_dkv,
    flash_dkv_plain, flash_dq, flash_dq_plain, flash_forward,
    flash_forward_plain, paged_attention, paged_attention_reference,
    paged_decode_attention, paged_decode_attention_plain, paged_kv_update,
    paged_prefill_attention, reference_attention)
from ray_tpu_torch.ops.cross_entropy import fused_cross_entropy  # noqa: F401
