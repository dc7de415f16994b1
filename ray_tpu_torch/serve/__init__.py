"""ray_tpu_torch.serve — the port's serving deployments (port of the
engine-building parts of ray_tpu/serve/).

`LLMDeployment` (llm.py) and the disaggregated `PrefillLLMDeployment` /
`DecodeLLMDeployment` (kv_tier/disagg.py) are plain classes over the
port's `InferenceEngine`: the port imports no `ray_tpu`, so a caller
binds them with `ray_tpu.serve.deployment(...)` and serves them with the
reference's control plane, router and `DisaggLLMHandle` unchanged.
"""

from ray_tpu_torch.serve.llm import (  # noqa: F401
    LLMDeployment, llm_stream_resume)
from ray_tpu_torch.serve.kv_tier import (  # noqa: F401
    DecodeLLMDeployment, KVBlockCodec, KVCodecError, KVTierCache,
    PrefillLLMDeployment)
