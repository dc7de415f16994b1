"""Ops of the port: paged-KV attention with a hand-written Hopper kernel."""

from ray_tpu_torch.ops.attention import (  # noqa: F401
    NEG_INF, paged_attention, paged_attention_reference,
    paged_decode_attention, paged_decode_attention_plain, paged_kv_update)
