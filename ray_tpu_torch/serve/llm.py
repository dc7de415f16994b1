"""LLM serving front end over the port's continuous-batching engine
(port of ray_tpu/serve/llm.py).

One InferenceEngine per replica.  Every serve request — streaming or
not — submits into the replica's shared lane array, so concurrent
requests batch onto the same decode step instead of running the model
once per request.

What the port does differently: `LLMDeployment` is a plain class, not a
`@serve.deployment`, because the port imports no `ray_tpu`.  A caller
binds it with the reference's serve plane (`serve` is `ray_tpu.serve`)::

    app = serve.deployment(name="llm")(LLMDeployment).bind(
        model="gpt", config="gpt2-small", max_lanes=32)
    handle = serve.run(app)
    for tok in handle.options("generate").stream([1, 2, 3],
                                                 max_new_tokens=16):
        ...

and the knobs the reference reads from `GLOBAL_CONFIG` are constructor
arguments with that config's defaults: `spec_k` (4 when `speculative`),
`spec_adaptive` (True), `prefix_summary_size` (256), plus `device`
(None means CUDA) and `observer` (util/observe.Observer).

Mid-stream failover: pair the handle with `llm_stream_resume`
(``handle.options("generate", failover=llm_stream_resume)``) and a
replica death mid-generation is absorbed by resubmitting with the
already-produced tokens appended to the prompt; ``_produced_offset``
keeps the sampling keys aligned, so greedy and seeded streams resume
token-exact.
"""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.inference import InferenceEngine

# The reference config's `spec_k` and `serve_prefix_summary_size`.
SPEC_K = 4
PREFIX_SUMMARY_SIZE = 256


def llm_stream_resume(args, kwargs, received):
    """Failover policy for LLMDeployment.generate streams: resume the
    generation where the dead replica stopped instead of replaying it.

    Rewrites (args, kwargs) so the resubmitted request carries
    ``prompt + received`` as its prompt, a decremented token budget, and
    ``_produced_offset=len(received)`` to keep the sampling keys aligned
    with the original request.  Returns None when the stream was
    already complete (budget exhausted or EOS emitted), which ends the
    stream cleanly instead of resubmitting a no-op request."""
    args = list(args)
    kwargs = dict(kwargs)
    if args:
        prompt = args.pop(0)
    else:
        prompt = kwargs.pop("prompt")
    if args:
        budget = args.pop(0)
    else:
        budget = kwargs.pop("max_new_tokens", 16)
    # Anything left positionally maps onto generate()'s signature order.
    for name, val in zip(("temperature", "eos_id", "seed"), args):
        kwargs.setdefault(name, val)
    received = [int(t) for t in received]
    remaining = int(budget) - len(received)
    if remaining <= 0:
        return None
    eos_id = kwargs.get("eos_id")
    if eos_id is not None and received and received[-1] == int(eos_id):
        return None
    new_prompt = [int(t) for t in prompt] + received
    kwargs["max_new_tokens"] = remaining
    kwargs["_produced_offset"] = len(received)
    return (new_prompt,), kwargs


class LLMDeployment:
    """Replica callable wrapping the port's InferenceEngine (the
    reference's `LLMDeployment`, with its methods and signatures)."""

    def __init__(self, model="gpt", config="nano", params=None, *,
                 max_lanes: int = 8, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 prefill_chunk: int = 32, seed: int = 0,
                 prefix_cache: bool = True, speculative: bool = False,
                 spec_k: Optional[int] = None, draft_proposer="ngram",
                 kv_tier: Optional[bool] = None, spec_adaptive: bool = True,
                 prefix_summary_size: int = PREFIX_SUMMARY_SIZE,
                 device=None, observer=None):
        # `speculative=True` opts the replica into speculative decoding;
        # the draft length defaults to the reference config's spec_k
        # unless pinned per deployment.
        if spec_k is None:
            spec_k = SPEC_K if speculative else 0
        self._summary_size = prefix_summary_size
        self._engine = InferenceEngine(
            model, config, params, max_lanes=max_lanes,
            block_size=block_size, num_blocks=num_blocks,
            max_seq_len=max_seq_len, prefill_chunk=prefill_chunk,
            seed=seed, prefix_cache=prefix_cache, spec_k=int(spec_k),
            draft_proposer=draft_proposer, spec_adaptive=spec_adaptive,
            kv_tier=kv_tier, device=device, observer=observer)

    def generate(self, prompt, max_new_tokens: int = 16,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 seed: Optional[int] = None, _produced_offset: int = 0,
                 _deadline_s: Optional[float] = None):
        """Streaming entry point: a generator, so serve hands the caller
        a stream ticket and each token is pulled as the engine emits it.

        `_produced_offset` / `_deadline_s` are serve-plane plumbing: the
        failover policy sets the offset so a resumed request samples with
        the original request's key sequence, and the replica injects the
        remaining deadline budget so the engine evicts the lane once it
        lapses."""
        handle = self._engine.submit(prompt, max_new_tokens,
                                     temperature=temperature,
                                     eos_id=eos_id, seed=seed,
                                     sample_offset=_produced_offset,
                                     deadline_s=_deadline_s)
        try:
            for tok in handle:
                yield int(tok)
        finally:
            # Consumer gone mid-stream (cancel, deadline, disconnect):
            # evict the lane so the engine stops decoding for nobody.
            handle.cancel()

    def __call__(self, prompt, max_new_tokens: int = 16,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 seed: Optional[int] = None,
                 _deadline_s: Optional[float] = None) -> List[int]:
        """Non-streaming: block until the sequence finishes (or the
        propagated request deadline cancels it)."""
        handle = self._engine.submit(prompt, max_new_tokens,
                                     temperature=temperature,
                                     eos_id=eos_id, seed=seed)
        return handle.tokens(timeout=_deadline_s)

    def prefix_summary(self) -> dict:
        """Compact prefix-index summary for prefix-cache-aware routing,
        bounded by `prefix_summary_size` — never the full index."""
        return self._engine.prefix_summary(self._summary_size)

    def stats(self) -> dict:
        """Engine occupancy + prefix-cache + speculative counters."""
        return self._engine.stats()
