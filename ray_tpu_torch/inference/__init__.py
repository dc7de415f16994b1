"""ray_tpu_torch.inference — the paged-KV continuous-batching engine.

Paged KV cache (fixed-size blocks in a preallocated pool, per-sequence
block tables, content-addressed prefix sharing), single-query decode
attention (the Hopper kernel in ops/csrc/paged_decode.cu), and a
continuous-batching scheduler whose in-step sampling is token-exact with
the JAX reference's threefry draws.
"""

from ray_tpu_torch.inference.kv_cache import (  # noqa: F401
    BlockAllocator, PagedKVCache, chain_hashes)
from ray_tpu_torch.inference.engine import (  # noqa: F401
    GenerationHandle, InferenceEngine)
