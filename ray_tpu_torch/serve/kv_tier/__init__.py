"""ray_tpu_torch.serve.kv_tier — the port of ray_tpu/serve/kv_tier/.

- ``codec.KVBlockCodec`` — wire format for sealed KV blocks + their
  hash-chain metadata (the reference's v1 frame for float32 pools, a v2
  frame carrying bf16 as uint16 bits).
- ``tier.KVTierCache`` — host-memory → injected store / disk spill tiers
  for refcount-0 sealed blocks, ``kv_tier_*`` counters.
- ``disagg`` — plain prefill and decode deployment classes over the
  port's engine.  The reference's ``DisaggLLMHandle`` and
  ``run_disaggregated`` build no engine and are not ported: bind these
  classes with ``ray_tpu.serve.deployment`` and front them with the
  reference's handle.
"""

from ray_tpu_torch.serve.kv_tier.codec import (  # noqa: F401
    KVBlockCodec, KVCodecError)
from ray_tpu_torch.serve.kv_tier.tier import KVTierCache  # noqa: F401
from ray_tpu_torch.serve.kv_tier.disagg import (  # noqa: F401
    DecodeLLMDeployment, PrefillLLMDeployment)
