"""Prefill/decode disaggregation over the port's engine (port of the
engine-building half of ray_tpu/serve/kv_tier/disagg.py).

Two dedicated replica classes instead of one monolithic LLM replica:

- ``PrefillLLMDeployment`` runs chunked prefill ONLY (never decode, never
  speculate).  A ``prefill()`` call seals the prompt's KV blocks into the
  replica's prefix index and returns them as one ``KVBlockCodec`` frame.
- ``DecodeLLMDeployment`` streams tokens.  ``generate()`` accepts an
  optional ``kv_handoff`` frame and installs it into the local cache as
  sealed prefix blocks before submitting, so decode starts from the
  shipped prefix instead of re-running prefill.  A bad frame is a cache
  miss: the prompt is prefilled here.

What the port does differently: both are plain classes (the port
imports no `ray_tpu`), with the reference's signatures plus `device`
and `observer`.  The reference's ``DisaggLLMHandle`` and
``run_disaggregated`` build no engine — they only drive serve handles —
so they are not ported: bind these classes with the reference's serve
plane (`serve` is `ray_tpu.serve`) and front them with its
`ray_tpu.serve.kv_tier.DisaggLLMHandle`::

    prefill = serve.run(serve.deployment(name="llm-prefill")(
        PrefillLLMDeployment).bind(model="llama", config="llama-1b"))
    decode = serve.run(serve.deployment(name="llm-decode")(
        DecodeLLMDeployment).bind(model="llama", config="llama-1b"))
    tokens = DisaggLLMHandle(prefill, decode).generate(prompt, 32)

A bf16 replica ships a v2 frame (codec.py), which a JAX decode replica
refuses, so there a port prefill costs a re-prefill, never a misread.
"""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.inference import InferenceEngine
from ray_tpu_torch.serve.kv_tier.codec import KVBlockCodec
from ray_tpu_torch.serve.llm import LLMDeployment


class PrefillLLMDeployment:
    """Prefill-only replica: seals prompt KV, exports sealed frames.

    Runs no decode steps for callers, so its lanes turn over at prefill
    latency and a burst of long cold prompts never sits behind decode
    steps."""

    def __init__(self, model="gpt", config="nano", params=None, *,
                 max_lanes: int = 8, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 prefill_chunk: int = 32, seed: int = 0,
                 kv_tier: Optional[bool] = None, device=None, observer=None):
        self._engine = InferenceEngine(
            model, config, params, max_lanes=max_lanes,
            block_size=block_size, num_blocks=num_blocks,
            max_seq_len=max_seq_len, prefill_chunk=prefill_chunk,
            seed=seed, prefix_cache=True, spec_k=0, kv_tier=kv_tier,
            device=device, observer=observer)

    def prefill(self, prompt, seed: Optional[int] = None,
                _deadline_s: Optional[float] = None) -> Optional[bytes]:
        """Chunked-prefill `prompt`, seal its blocks, return them as one
        encoded KV frame (None when the prompt is too short to seal a
        single full block — the decode side just prefills it all)."""
        prompt = [int(t) for t in prompt]
        handle = self._engine.prefill(prompt, seed=seed,
                                      deadline_s=_deadline_s)
        handle.tokens(timeout=_deadline_s)   # drain: no tokens, by design
        payload = self._engine.export_prefix(prompt)
        if payload is None:
            return None
        return KVBlockCodec.encode(payload)

    def prefix_summary(self) -> dict:
        return self._engine.prefix_summary()

    def stats(self) -> dict:
        return self._engine.stats()


class DecodeLLMDeployment(LLMDeployment):
    """Decode replica: adopts shipped prefixes, streams tokens.

    ``generate`` keeps ``LLMDeployment.generate``'s signature and adds
    ``kv_handoff``, so ``llm_stream_resume`` works unchanged; the frame
    rides kwargs through a mid-stream resume and re-imports idempotently
    on the healed replica.  Takes LLMDeployment's arguments, with the
    prefix cache always on."""

    def __init__(self, model="gpt", config="nano", params=None, **kw):
        super().__init__(model, config, params, prefix_cache=True, **kw)

    def _adopt(self, kv_handoff) -> None:
        if kv_handoff is None:
            return
        payload = KVBlockCodec.try_decode(kv_handoff)
        if payload is None:
            return                       # bad frame == cache miss
        self._engine.import_prefix(payload)

    def generate(self, prompt, max_new_tokens: int = 16,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 seed: Optional[int] = None, _produced_offset: int = 0,
                 _deadline_s: Optional[float] = None, kv_handoff=None):
        self._adopt(kv_handoff)
        yield from super().generate(prompt, max_new_tokens, temperature,
                                    eos_id, seed, _produced_offset,
                                    _deadline_s)

    def __call__(self, prompt, max_new_tokens: int = 16,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 seed: Optional[int] = None,
                 _deadline_s: Optional[float] = None,
                 kv_handoff=None) -> List[int]:
        self._adopt(kv_handoff)
        return super().__call__(prompt, max_new_tokens, temperature, eos_id,
                                seed, _deadline_s)
