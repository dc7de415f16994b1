"""Continuous-batching generation engine over the paged KV cache
(port of ray_tpu/inference/engine.py).

One step advances a fixed-capacity LANE array: every live sequence owns
a lane, new requests are admitted into lanes the moment their previous
occupant finishes (mid-flight — no batch barrier), and padding lanes
ride along masked.  Two step shapes: the pure decode step (T=1, the
single-query paged-decode kernel) and the prefill step
(T=prefill_chunk); when both populations are live they dispatch
SEPARATELY each scheduler iteration, so decode lanes advance at T=1
cost.

Admission rides the prefix cache (kv_cache.py): the longest
block-aligned cached prefix of a prompt is adopted by reference instead
of re-prefilled.  Newly-full blocks are sealed into the content-addressed
index as the write cursor crosses them — mid-prefill included.

Sampling is part of the step: greedy is argmax, temperature sampling
draws from fold_in(key(request seed), tokens produced) with JAX's
threefry (sampling.py), so sampled output is token-exact with the
reference and independent of batch composition.  The step's only
device->host transfer is one int32 per lane (and, with
`capture_logp=True`, one float32 behaviour log-prob per token) — never
the [B, V] logits.

Speculative decoding (`spec_k > 0`, speculative.py) lifts the
one-token-per-step ceiling: a draft proposer suggests up to k
continuation tokens per decode lane, the step verifies all k+1
positions at once (a third step shape, T = 1 + the widest draft, through
the masked-dense paged path, sampling every position j with the SAME
fold_in(seed, produced + j) key the plain step would use), the longest
draft prefix matching the model's own output commits as one atomic
burst, and the rejected tail rolls back through paged-KV block
truncation — token-exact with the plain engine for greedy and seeded
sampling alike.  A decode step in which no lane drafted is the plain
T=1 step.

The engine is host-driven: block allocation, admission and stream
fan-out are Python; the model math is one plain Python step function
per dispatched population (there is no jit), and it writes the new K/V
into the cache's pools IN PLACE (`index_copy_` in paged_kv_update).

Disaggregated serving: `prefill()` runs a prefill-only request (its
blocks sealed, no token sampled or streamed), `export_prefix` snapshots
the sealed chain for a decode engine, whose `import_prefix` installs it;
`kv_tier=True` spills evicted sealed blocks to host memory, then an
injected store or disk, and restores them on a prefix hit.  A step's
K/V writes land in place while the lock is released, so a lane that
finishes mid-step (cancel, deadline) frees its blocks only once that
step is done: an import may then allocate them without racing the
step's writes.

A family whose layers mix sliding-window and full attention (mellum)
keeps two kinds of KV state (kv_cache.py `WindowPool`): the full
layers' pool, every position, and the window layers' pool, sized by the
engine itself at `max_lanes` x `WindowPool.lane_cap` blocks, where a
lane holds only the blocks its window still shows, so admission and the
growth reserve reckon over the full pool alone: the window pool cannot
run out.  Such a family has no prefix
reuse, and `spec_k > 0` or `kv_tier` raise ValueError.  A family that
counts on the device (`COUNTERS`, such as the expert layer's routed
pairs and weight loads) gets an int64 tensor per dispatch kind that its
cached forward adds to without a sync; `stats()` reads them.

Observability goes through an injected `Observer` (util/observe.py)
with the reference's metric names and (plane, kind) pairs; the port
imports nothing of `ray_tpu.util`.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ray_tpu_torch import models
from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.inference import sampling
from ray_tpu_torch.inference.kv_cache import PagedKVCache
from ray_tpu_torch.inference.speculative import resolve_draft_proposer
from ray_tpu_torch.util.observe import NOOP, Observer

_DONE = object()


@dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    seed: int = 0
    out: "queue.Queue" = field(default_factory=queue.Queue)
    # Sampling-counter base: a request resumed after a mid-stream
    # failover re-prefills prompt+produced but must keep drawing from
    # fold_in(seed, OVERALL position) to stay seed-consistent.
    sample_offset: int = 0
    deadline: Optional[float] = None   # monotonic; lane evicted past it
    # Observer bookkeeping: the trace context is captured at submit()
    # time because every later hop (scheduler thread, _commit) runs
    # outside the submitter's context.
    trace: Optional[tuple] = None
    submitted: float = 0.0             # wall time of submit()
    last_emit: float = 0.0             # wall time of the previous token
    # Open span for TRACED requests only: prefill (submit -> first
    # token) until produced == 1, then the current inter-token span.
    span_tok: object = None
    fed: int = 0            # prompt tokens in the cache (prefilled OR reused)
    produced: int = 0
    last_token: int = 0
    emitted: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None
    # Speculative state: the lane's current adaptive draft ceiling and
    # the draft tokens riding the in-flight verify dispatch.
    spec_k: int = 0
    draft: tuple = ()
    # Per-token behaviour log-probs (capture_logp engines only), parallel
    # to `emitted`.
    logps: List[float] = field(default_factory=list)
    # Disaggregated prefill: run chunked prefill + seal the prompt's
    # blocks, then finish WITHOUT sampling — the sealed chain is the
    # product (export_prefix ships it to a decode engine).
    prefill_only: bool = False

    @property
    def prefilling(self) -> bool:
        return self.fed < len(self.prompt)


class GenerationHandle:
    """Streaming view of one request: iterate to receive token ids as
    the engine emits them."""

    def __init__(self, req: _Request, engine: "InferenceEngine" = None):
        self._req = req
        self._engine = engine
        # A speculative burst arrives as ONE queue item (a list): the
        # commit is atomic — a consumer never observes a partially
        # delivered draft burst — and iteration unwraps it here.
        self._buf: collections.deque = collections.deque()

    def cancel(self) -> bool:
        """Abort the request: evict its engine lane (or dequeue it) and
        unblock any consumer with end-of-stream.  Idempotent; False if
        the request had already finished."""
        if self._engine is None:
            return False
        return self._engine.cancel(self._req)

    def __iter__(self):
        return self

    def __next__(self) -> int:
        if self._buf:
            return self._buf.popleft()
        item = self._req.out.get()
        if item is _DONE:
            raise StopIteration
        if isinstance(item, list):
            self._buf.extend(item)
            return self._buf.popleft()
        return item

    def tokens(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the request finishes; returns all generated ids.

        `timeout` is an OVERALL deadline for the whole generation: if the
        request has not finished `timeout` seconds from this call, it is
        CANCELLED (its lane evicted) and TimeoutError is raised."""
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[int] = list(self._buf)
        self._buf.clear()
        while True:
            try:
                item = self._req.out.get(
                    timeout=None if deadline is None
                    else max(deadline - time.monotonic(), 0.0))
            except queue.Empty:
                self.cancel()
                raise TimeoutError(
                    f"generation did not finish within {timeout}s "
                    f"({len(out)} token(s) received)") from None
            if item is _DONE:
                return out
            if isinstance(item, list):
                out.extend(item)
            else:
                out.append(item)

    @property
    def finish_reason(self) -> Optional[str]:
        return self._req.finish_reason

    @property
    def logps(self) -> List[float]:
        """Behaviour log-probs of the committed tokens (parallel to the
        emitted stream).  Empty unless the engine was built with
        ``capture_logp=True``."""
        return list(self._req.logps)


class InferenceEngine:
    """max_lanes concurrent sequences over one shared paged KV pool.

    `model` is "gpt", "llama" or a module with the same cached-forward
    contract (`forward_cached`, `lm_head`, `working_params`, `CONFIGS`);
    `config` a name in its `CONFIGS` or a config object.
    `auto_start=True` (default) runs the scheduler on a daemon thread —
    submit() returns a streaming GenerationHandle immediately.  With
    auto_start=False the caller drives `step()`.  `prefix_cache=False`
    disables content-addressed block reuse.  `device=None` means CUDA
    (raises without a card); tests pass `device="cpu"`.

    `spec_k > 0` enables speculative decoding: `draft_proposer`
    (``"ngram"`` or a speculative.DraftProposer) suggests up to spec_k
    continuation tokens per decode lane and one verify dispatch commits
    the accepted prefix as a burst.  `spec_adaptive` backs each lane's
    draft length off when its acceptance is low (and grows it back on
    full acceptance).  `capture_logp=True` records each committed
    token's behaviour log-prob (`GenerationHandle.logps`).

    `kv_tier=True` (off when None, as in the reference config) attaches
    a spill tier of `kv_tier_host_blocks` host blocks and
    `kv_tier_store_blocks` store blocks: the store is `kv_store`, a
    `(put, get)` pair over bytes, or files under `spill_dir` without one.
    `observer` (util/observe.Observer) receives the reference's metrics,
    events and spans; None records nothing.

    A windowed family (a config with `n_window_layers`, as mellum's)
    serves with its window layers' KV in a pool of their own that the
    engine sizes from `max_lanes`, `prefill_chunk` and the window
    (`num_blocks` is the full layers' pool); prefix reuse is off for it,
    and `spec_k > 0` or `kv_tier` raise ValueError.
    """

    def __init__(self, model="gpt", config="nano", params=None, *,
                 max_lanes: int = 8, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 prefill_chunk: int = 32, seed: int = 0,
                 prefix_cache: bool = True, auto_start: bool = True,
                 spec_k: int = 0, draft_proposer="ngram",
                 spec_adaptive: bool = True, kv_tier: Optional[bool] = None,
                 kv_tier_host_blocks: int = 256,
                 kv_tier_store_blocks: int = 1024,
                 spill_dir: Optional[str] = None, kv_store=None,
                 capture_logp: bool = False, device: DeviceLike = None,
                 observer: Optional[Observer] = None):
        self.device = resolve_device(device)
        self._obs = observer or NOOP
        self.model = models.family(model)
        self.config = (self.model.CONFIGS[config] if isinstance(config, str)
                       else config)
        if params is None:
            params = self.model.init_params(
                self.config, torch.Generator().manual_seed(seed), self.device)
        self._set_params(params)
        self.max_lanes = max_lanes
        self.prefill_chunk = prefill_chunk
        self.seed = seed
        if getattr(self.config, "n_window_layers", 0):
            # The window pool holds no sealed history to roll back into,
            # spill or share.
            if spec_k > 0:
                raise ValueError("spec_k > 0 needs rollback of the window "
                                 "pool, which a windowed family lacks")
            if kv_tier:
                raise ValueError("kv_tier spills sealed prefix blocks, "
                                 "which a windowed family does not keep")
        max_seq_len = min(max_seq_len or self.config.max_seq_len,
                          self.config.max_seq_len)
        if num_blocks is None:
            num_blocks = max_lanes * -(-max_seq_len // block_size)
        self.cache = PagedKVCache.for_model(
            self.model, self.config, num_blocks=num_blocks,
            block_size=block_size, max_lanes=max_lanes,
            max_seq_len=max_seq_len, prefix_cache=prefix_cache,
            device=self.device, prefill_chunk=prefill_chunk)
        # The family's device counters, one int64 row per dispatch kind.
        self._counter_names = tuple(getattr(self.model, "COUNTERS", ()))
        self._dev_counts = {
            kind: torch.zeros(len(self._counter_names), dtype=torch.int64,
                              device=self.device)
            for kind in ("prefill", "decode")} if self._counter_names \
            else None
        self._reported: dict = {}
        if kv_tier and prefix_cache:
            # Runtime import: the tier lives with the serving package,
            # whose deployments import this module.
            from ray_tpu_torch.serve.kv_tier.tier import KVTierCache
            self.cache.attach_tier(KVTierCache(
                kv_tier_host_blocks, kv_tier_store_blocks,
                spill_dir=spill_dir, store=kv_store, observer=self._obs))
        self.spec_k = int(spec_k)
        self._spec_adaptive = bool(spec_adaptive)
        self._proposer = (resolve_draft_proposer(draft_proposer)
                          if self.spec_k > 0 else None)
        self._spec_stats = {"drafted": 0, "accepted": 0, "emitted": 0,
                            "steps": 0, "bursts": 0}
        self._capture_logp = bool(capture_logp)
        self.policy_version = 0
        self._lanes: List[Optional[_Request]] = [None] * max_lanes
        self._waiting: "collections.deque[_Request]" = collections.deque()
        self._rid = itertools.count(1)
        self._steps = {"decode_steps": 0, "decode_seconds": 0.0,
                       "verify_steps": 0, "verify_seconds": 0.0,
                       "prefill_steps": 0, "prefill_seconds": 0.0}
        self._evictions_reported = 0
        # Lanes of the dispatch in flight, and those of them finished
        # (cancel, deadline) while it ran: their blocks are freed when
        # the step commits, after its last write into them.
        self._stepping: set = set()
        self._free_after_step: List[int] = []
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._auto = auto_start

    def _set_params(self, params) -> None:
        self.params = params
        # The step reads a working copy: weights cast to the activation
        # dtype once here instead of at every step (same bits).
        self._work_params = self.model.working_params(params, self.config,
                                                      self.device)

    # ---------------- public API ----------------

    def submit(self, prompt, max_new_tokens: int = 16, *,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               seed: Optional[int] = None, sample_offset: int = 0,
               deadline_s: Optional[float] = None,
               prefill_only: bool = False) -> GenerationHandle:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        vocab = self.config.vocab_size
        for t in prompt:
            if not 0 <= t < vocab:
                raise ValueError(
                    f"prompt token id {t} out of range for vocab_size "
                    f"{vocab}")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) > self.cache.max_seq_len:
            raise ValueError("prompt longer than max_seq_len")
        rid = next(self._rid)
        req = _Request(rid=rid, prompt=prompt,
                       max_new_tokens=max_new_tokens,
                       temperature=temperature, eos_id=eos_id,
                       seed=seed if seed is not None else self.seed + rid,
                       sample_offset=int(sample_offset),
                       deadline=(None if deadline_s is None
                                 else time.monotonic() + deadline_s),
                       trace=self._obs.context(), submitted=time.time(),
                       spec_k=self.spec_k, prefill_only=prefill_only)
        self._obs.record("engine", "submit", trace=req.trace, rid=rid,
                         prompt_len=len(prompt), max_new=max_new_tokens)
        if req.trace is not None:
            # Prefill span: submit -> first emitted token (TTFT, queue
            # wait included); _commit swaps it for per-token spans.
            req.span_tok = self._obs.begin("engine", "prefill", ctx=req.trace,
                                           rid=rid, prompt_len=len(prompt))
        with self._work:
            if self._stopped:
                raise RuntimeError("engine is shut down")
            self._waiting.append(req)
            self._work.notify()
        if self._auto:
            self._ensure_thread()
        return GenerationHandle(req, self)

    def generate(self, prompt, max_new_tokens: int = 16, *,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 seed: Optional[int] = None) -> List[int]:
        """Blocking convenience wrapper: submit + drain."""
        h = self.submit(prompt, max_new_tokens, temperature=temperature,
                        eos_id=eos_id, seed=seed)
        if not self._auto:
            while self.step():
                pass
        return h.tokens()

    def update_params(self, params, version: Optional[int] = None) -> int:
        """Swap the model weights between scheduler steps: in-flight lanes
        keep their KV state and continue under the NEW weights at the
        next dispatch.  Returns the new policy version (`version` when
        given, else the previous version + 1)."""
        with self._work:
            self._set_params(params)
            self.policy_version = (int(version) if version is not None
                                   else self.policy_version + 1)
            self._obs.record("engine", "weights_swap",
                             version=self.policy_version,
                             live_lanes=self.num_active)
            self._work.notify()
            return self.policy_version

    # -------- disaggregated prefill/decode (serve/kv_tier) --------

    def prefill(self, prompt, *, seed: Optional[int] = None,
                deadline_s: Optional[float] = None) -> GenerationHandle:
        """Run chunked prefill for `prompt` and seal its KV blocks into
        the prefix index WITHOUT sampling a token (finish_reason
        "prefill").  The handle drains empty; the product is the sealed
        chain, which `export_prefix` snapshots for a decode engine."""
        h = self.submit(prompt, 1, seed=seed, deadline_s=deadline_s,
                        prefill_only=True)
        if not self._auto:
            while self.step():
                pass
        return h

    def export_prefix(self, tokens) -> Optional[dict]:
        """Snapshot the longest device-cached chain covering `tokens`
        (see PagedKVCache.export_prefix) under the engine lock, so the
        scheduler can't reshuffle blocks mid-gather."""
        tokens = [int(t) for t in tokens]
        with self._lock:
            tok = self._obs.begin("kv", "export", tokens=len(tokens))
            try:
                return self.cache.export_prefix(tokens)
            finally:
                self._obs.end(tok)

    def import_prefix(self, payload: dict) -> int:
        """Adopt a foreign sealed chain (the prefill→decode handoff)
        under the engine lock; returns blocks installed.  Idempotent —
        see PagedKVCache.install_prefix."""
        with self._lock:
            tok = self._obs.begin("kv", "import")
            try:
                return self.cache.install_prefix(payload)
            finally:
                self._obs.end(tok)

    def prefix_summary(self, limit: Optional[int] = None) -> dict:
        """Routing summary of this engine's cached chains (device index
        + spill tier), bounded by `limit` (256 when None, the reference
        config's `serve_prefix_summary_size`)."""
        with self._lock:
            return self.cache.prefix_summary(256 if limit is None else limit)

    def cancel(self, req: _Request) -> bool:
        """Abort one request: dequeue it if still waiting, or evict its
        lane (freeing the KV blocks) if live.  The consumer is unblocked
        with end-of-stream; finish_reason becomes "cancelled".  False if
        the request had already finished (idempotent)."""
        with self._work:
            try:
                self._waiting.remove(req)
            except ValueError:
                pass
            else:
                self._finish(None, req, "cancelled", ok=False)
                return True
            for lane, r in enumerate(self._lanes):
                if r is req:
                    self._finish(lane, req, "cancelled", ok=False)
                    self._obs.record("engine", "lane_evict", trace=req.trace,
                                     rid=req.rid, lane=lane,
                                     reason="cancelled")
                    return True
        return False

    def _finish(self, lane: Optional[int], req: _Request, reason: str,
                **span_end) -> None:
        """End a request's stream, close its open span with `span_end`
        and free its lane — once the step in flight, if it runs this
        lane, has committed (caller holds the lock).  The stream ends
        last, so a caller woken by its end finds the lane released."""
        req.finish_reason = reason
        self._obs.end(req.span_tok, **span_end)
        req.span_tok = None
        if lane is not None:
            self._lanes[lane] = None
            if lane in self._stepping:
                self._free_after_step.append(lane)
            else:
                self.cache.free_lane(lane)
        req.out.put(_DONE)

    def _expire_deadlines(self) -> None:
        """Evict every lane (and drop every queued request) whose
        deadline lapsed.  Caller holds the lock."""
        now = time.monotonic()
        for lane, req in enumerate(self._lanes):
            if req is not None and req.deadline is not None \
                    and now > req.deadline:
                self._finish(lane, req, "deadline", ok=False)
                self._obs.record("engine", "deadline_kill", trace=req.trace,
                                 rid=req.rid, lane=lane,
                                 produced=req.produced)
        for req in [r for r in self._waiting
                    if r.deadline is not None and now > r.deadline]:
            self._waiting.remove(req)
            self._finish(None, req, "deadline", ok=False)
            self._obs.record("engine", "deadline_kill", trace=req.trace,
                             rid=req.rid, lane=None, produced=0)

    def shutdown(self) -> None:
        with self._work:
            self._stopped = True
            for req in self._waiting:
                req.out.put(_DONE)
            self._waiting.clear()
            for lane, req in enumerate(self._lanes):
                if req is not None:
                    req.out.put(_DONE)
                    self.cache.free_lane(lane)
                    self._lanes[lane] = None
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._lanes)

    @property
    def num_waiting(self) -> int:
        return len(self._waiting)

    def stats(self) -> dict:
        """Engine occupancy, prefix-cache counters, speculative acceptance
        counters and step counters (dispatches and host seconds per step
        shape — plain decode, verify, prefill — each ending in the step's
        device->host transfer)."""
        cs = self.cache.stats
        st = self._spec_stats
        return {
            **self._window_stats(),
            **self._device_counts(),
            "active": self.num_active,
            "waiting": self.num_waiting,
            "max_lanes": self.max_lanes,
            "free_blocks": self.cache.allocator.num_free,
            "cached_blocks": self.cache.num_indexed_blocks,
            "prefix_hits": cs["hits"],
            "prefix_misses": cs["misses"],
            "prefix_hit_tokens": cs["hit_tokens"],
            "prefix_miss_tokens": cs["miss_tokens"],
            "blocks_evicted": self.cache.allocator.evictions,
            "imported_blocks": cs["imported_blocks"],
            "restored_blocks": cs["restored_blocks"],
            **(self.cache.tier.counters if self.cache.tier is not None
               else {}),
            "policy_version": self.policy_version,
            "spec_k": self.spec_k,
            "spec_drafted_tokens": st["drafted"],
            "spec_accepted_tokens": st["accepted"],
            "spec_emitted_tokens": st["emitted"],
            "spec_steps": st["steps"],
            # Tokens per lane per verify step — plain decode is 1.0, so
            # anything above 1 is the speculative multiplier.
            "spec_accepted_per_step": (st["emitted"] / st["bursts"]
                                       if st["bursts"] else 0.0),
            **self._steps,
        }

    def _window_stats(self) -> dict:
        """The window pool's blocks given back so far and held now, also
        reported to the Observer: the first as a counter (by what it
        gained since the last read), the second as a gauge."""
        w = self.cache.window
        if w is None:
            return {}
        gained = w.released - self._reported.get("kv_window_blocks_released",
                                                 0)
        if gained:
            self._obs.inc("kv_window_blocks_released", gained)
        self._reported["kv_window_blocks_released"] = w.released
        self._obs.set("kv_window_blocks_resident", w.resident)
        return {"kv_window_blocks_released": w.released,
                "kv_window_blocks_resident": w.resident}

    def _device_counts(self) -> dict:
        """The family's device counters by dispatch kind
        (`<name>_<kind>`), read from the device (a sync), each also
        reported to the Observer as a counter by what it gained since
        the last read."""
        if self._dev_counts is None:
            return {}
        out = {}
        for kind, row in self._dev_counts.items():
            for name, value in zip(self._counter_names, row.tolist()):
                key = f"{name}_{kind}"
                out[key] = value
                gained = value - self._reported.get(key, 0)
                if gained:
                    self._obs.inc(f"inference_{key}", gained)
                self._reported[key] = value
        return out

    # ---------------- scheduler ----------------

    def _ensure_thread(self):
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="inference-engine")
            self._thread.start()

    def _loop(self):
        while True:
            with self._work:
                while (not self._stopped and not self._waiting
                       and all(r is None for r in self._lanes)):
                    self._work.wait()
                if self._stopped:
                    return
            self.step()

    def _final_len(self, req) -> int:
        return min(len(req.prompt) + req.max_new_tokens,
                   self.cache.max_seq_len)

    def _growth_reserve(self) -> int:
        """Blocks every LIVE lane may still claim before finishing (its
        worst-case final length minus what it already owns).  Admission
        leaves this much unclaimed so decode growth can never exhaust
        the pool mid-flight.  A window pool needs no reserve: it holds
        `lane_cap` blocks for every lane (`WindowPool`)."""
        reserve = 0
        for lane, req in enumerate(self._lanes):
            if req is None:
                continue
            reserve += (self.cache.blocks_needed(self._final_len(req))
                        - len(self.cache.lane_blocks(lane)))
        return reserve

    def _admit(self):
        """Fill free lanes from the FIFO queue — admission control is
        block-level: a request enters only when its worst-case final
        length fits alongside every live lane's worst case, counting
        cached prefix blocks as references, not allocations."""
        obs = self._obs
        for lane in range(self.max_lanes):
            if self._lanes[lane] is not None or not self._waiting:
                continue
            req = self._waiting[0]
            growth = (self.cache.blocks_needed(self._final_len(req))
                      - self.cache.blocks_needed(len(req.prompt)))
            if not self.cache.can_admit_prefix(
                    req.prompt,
                    headroom_blocks=self._growth_reserve() + growth):
                break  # FIFO: don't starve the head with later requests
            reused = self.cache.adopt_prefix(lane, req.prompt)
            self._waiting.popleft()
            req.fed = reused
            self._lanes[lane] = req
            obs.inc("inference_prefix_hit_tokens", reused)
            obs.inc("inference_prefix_miss_tokens", len(req.prompt) - reused)
            obs.inc("inference_prefix_hits" if reused
                    else "inference_prefix_misses")
            obs.record("engine", "prefix_hit" if reused else "prefix_miss",
                       trace=req.trace, rid=req.rid, lane=lane,
                       reused_tokens=reused, prompt_len=len(req.prompt))
        obs.set("inference_waiting_requests", len(self._waiting))
        evictions = self.cache.allocator.evictions
        if evictions > self._evictions_reported:
            n = evictions - self._evictions_reported
            obs.inc("inference_kv_blocks_evicted", n)
            obs.record("engine", "blocks_evicted", n=n)
            self._evictions_reported = evictions

    def _propose(self, lane: int, req: _Request) -> tuple:
        """Draft for one decode lane: ask the proposer for up to the
        lane's adaptive draft length, clamped so the verify chunk can
        never write past max_seq_len and never drafts beyond the token
        budget (the burst from k drafts is at most k+1 tokens)."""
        limit = min(req.spec_k,
                    req.max_new_tokens - req.produced - 1,
                    self.cache.max_seq_len - 1
                    - int(self.cache.seq_lens[lane]))
        if limit <= 0:
            return ()
        draft = self._proposer.propose(req.prompt + req.emitted, limit)
        vocab = self.config.vocab_size
        out = []
        for t in draft[:limit]:
            t = int(t)
            if not 0 <= t < vocab:
                break       # garbage proposal: verify nothing past it
            out.append(t)
        return tuple(out)

    def step(self) -> bool:
        """One scheduler iteration: admit, then advance every live lane.
        Decode lanes and prefilling lanes dispatch as SEPARATE steps
        (T=1 and T=prefill_chunk).  When speculation is on and any decode
        lane drafted, the decode population dispatches as ONE verify step
        sized to the widest draft proposed this step (T = 1 + max drafts,
        never more than spec_k + 1); draftless lanes ride along at
        chunk=1.  Returns False when fully idle."""
        with self._lock:
            self._expire_deadlines()
            self._admit()
            live = [(i, r) for i, r in enumerate(self._lanes)
                    if r is not None]
            if not live:
                return False
            obs = self._obs
            plans = []
            decode = [(i, r) for i, r in live if not r.prefilling]
            if decode:
                spec = False
                if self._proposer is not None:
                    dtok = obs.begin("engine", "spec_draft")
                    for lane, req in decode:
                        req.draft = self._propose(lane, req)
                    spec = any(r.draft for _, r in decode)
                    obs.end(dtok, lanes=len(decode),
                            drafted=sum(len(r.draft) for _, r in decode))
                t = 1 + max(len(r.draft) for _, r in decode) if spec else 1
                plans.append(("verify" if spec else "decode", decode,
                              self._build_batch(decode, t)))
            prefill = [(i, r) for i, r in live if r.prefilling]
            if prefill:
                plans.append(("prefill", prefill,
                              self._build_batch(prefill,
                                                self.prefill_chunk)))
            obs.record("engine", "step", decode=len(decode),
                       prefill=len(prefill), waiting=len(self._waiting))
            params = self._work_params
            self._stepping = {lane for lane, _ in live}
        done = []
        for kind, lanes, (batch, chunks) in plans:
            t0 = time.perf_counter()
            vtok = obs.begin("engine", "spec_verify") if kind == "verify" \
                else None
            toks, lps = self._run_step(
                params, *batch, spec=kind == "verify",
                counts=(None if self._dev_counts is None else
                        self._dev_counts["prefill" if kind == "prefill"
                                         else "decode"]))
            toks = toks.cpu().numpy().reshape(self.max_lanes, -1)
            if lps is not None:
                lps = lps.cpu().numpy().reshape(self.max_lanes, -1)
            obs.end(vtok, lanes=len(lanes))
            self._steps[f"{kind}_steps"] += 1
            self._steps[f"{kind}_seconds"] += time.perf_counter() - t0
            if kind == "verify":
                self._spec_stats["steps"] += 1
                obs.inc("inference_spec_steps")
            done.append((lanes, chunks, toks, lps))
        with self._work:
            # The step's writes are done (its tokens came back to the
            # host): lanes finished meanwhile may give up their blocks.
            self._stepping = set()
            for lane in self._free_after_step:
                self.cache.free_lane(lane)
            self._free_after_step = []
            for lanes, chunks, toks, lps in done:
                self._commit(lanes, chunks, toks, lps)
            self._work.notify()
        return True

    def _build_batch(self, live, t):
        """Host-side assembly of the fixed-shape lane arrays for one
        population (lanes not in `live` ride along fully masked)."""
        n = self.max_lanes
        tokens = np.zeros((n, t), np.int64)
        positions = np.zeros((n, t), np.int64)
        valid = np.zeros((n, t), bool)
        ctx_lens = np.ones((n,), np.int32)
        gather = np.zeros((n,), np.int64)
        temps = np.zeros((n,), np.float32)
        seeds = np.zeros((n,), np.int64)
        counters = np.zeros((n,), np.int64)
        chunks = {}
        sample = False
        for lane, req in live:
            start = int(self.cache.seq_lens[lane])
            if req.prefilling:
                chunk = min(t, len(req.prompt) - req.fed)
                tokens[lane, :chunk] = req.prompt[req.fed:req.fed + chunk]
            else:
                # Speculative lanes feed [last_token, d_1 .. d_k]; the
                # verify step samples every position.  Draftless lanes
                # are the plain chunk=1 decode, masked alongside: their
                # padded slots write no K/V (paged_kv_update).
                chunk = 1 + len(req.draft)
                tokens[lane, :chunk] = (req.last_token,) + req.draft
            positions[lane] = start + np.arange(t)
            valid[lane, :chunk] = True
            ctx_lens[lane] = start + chunk
            gather[lane] = chunk - 1
            temps[lane] = req.temperature
            seeds[lane] = req.seed & 0xFFFFFFFF
            counters[lane] = req.produced + req.sample_offset
            sample = sample or req.temperature > 0
            chunks[lane] = chunk
            # Table entries must exist before the step writes K/V.
            self.cache.ensure_capacity(lane, start + chunk)
        def dev(a):
            return torch.from_numpy(a).to(self.device)

        batch = (dev(tokens), dev(positions), dev(valid),
                 self.cache.device_tables(), dev(ctx_lens), dev(gather),
                 dev(temps), dev(seeds), dev(counters), sample)
        return batch, chunks

    @torch.no_grad()
    def _run_step(self, params, tokens, positions, valid, tables, ctx_lens,
                  gather, temps, seeds, counters, sample, *, spec=False,
                  counts=None):
        """The step function: cached forward (pools written in place),
        lm head, in-step sampling.  Plain and prefill steps take the head
        on each lane's last valid position only and return int32
        [max_lanes]; the verify step (`spec`) samples EVERY position —
        position j with the key the plain step would use after j more
        commits — and returns int32 [max_lanes, T].  The second result is
        the chosen tokens' float32 log-probs of the same shape with
        `capture_logp`, else None.  `counts`: the dispatch kind's device
        counters, for a family that has them."""
        model, config = self.model, self.config
        k_pool, v_pool = self.cache.pools()
        x, _, _ = model.forward_cached(
            params, tokens, positions, valid, k_pool, v_pool,
            tables, ctx_lens, config,
            **({} if counts is None else {"counts": counts}))
        if not spec:
            x = x[torch.arange(x.shape[0], device=x.device), gather]
        logits = model.lm_head(params, x, config)     # [B, V] / [B, T, V]
        out = torch.argmax(logits, dim=-1).to(torch.int32)
        if sample:
            sampled = sampling.sample(logits, temps, seeds, counters)
            lane_temps = temps.view(-1, *([1] * (out.dim() - 1)))
            out = torch.where(lane_temps > 0, sampled, out)
        lps = (sampling.logp_at(logits, out, temps) if self._capture_logp
               else None)
        return out, lps

    def _commit(self, live, chunks, toks, lps=None):
        """Apply one dispatch's results: advance prefill cursors, seal
        newly-full blocks into the prefix index, stream sampled tokens
        (a multi-token speculative burst commits ATOMICALLY — one queue
        item), roll back rejected draft blocks, finish + free lanes.

        `toks` is [max_lanes, T]: T=1 rows for prefill/plain decode, the
        per-position verify samples for a speculative dispatch; `lps`
        (capture_logp) is position-parallel with it."""
        obs = self._obs
        for lane, req in live:
            if self._lanes[lane] is not req:
                continue  # shutdown()/cancel() cleared the lane mid-step
            row = toks[lane]
            draft = req.draft
            req.draft = ()
            was_prefill = req.prefilling
            if was_prefill:
                req.fed += chunks[lane]
                self.cache.seq_lens[lane] += chunks[lane]
                self.cache.seal_full_blocks(lane, req.prompt)
                if req.prefilling:
                    continue  # more prompt to go; nothing sampled yet
                if req.prefill_only:
                    # Disaggregated prefill: the prompt's K/V is sealed
                    # (it survives the lane free as evictable blocks); no
                    # token is sampled or streamed and `produced` stays 0.
                    # The sampled row is discarded — the decode engine
                    # draws it with the same fold_in keys.
                    self._finish(lane, req, "prefill", tokens=0)
                    obs.record("engine", "finish", trace=req.trace,
                               rid=req.rid, reason="prefill", produced=0)
                    continue
                burst = [int(row[0])]
                accepted = 0
            else:
                # Exact-match verification: position j's K/V and sample
                # are only valid if every earlier fed draft matched the
                # model's own output, so the burst is the accepted draft
                # prefix plus the first divergent (or bonus) sample.
                accepted = 0
                while (accepted < len(draft)
                       and int(row[accepted]) == draft[accepted]):
                    accepted += 1
                burst = [int(row[j]) for j in range(accepted + 1)]
            # Clamp the burst when a stop condition lands mid-burst:
            # tokens past eos / the max_new_tokens budget were never
            # "generated" — they are discarded, not streamed.
            reason = None
            emit: List[int] = []
            for tok in burst:
                emit.append(tok)
                if req.eos_id is not None and tok == req.eos_id:
                    reason = "eos"
                    break
                if req.produced + len(emit) >= req.max_new_tokens:
                    reason = "length"
                    break
            m = len(emit)
            if not was_prefill:
                # Commit K/V for the m verified positions, release the
                # blocks the rejected tail claimed, and seal only what
                # is now committed history (sealing is bounded by
                # seq_lens, which counts accepted tokens only).
                self.cache.seq_lens[lane] += m
                if chunks[lane] > m:
                    self.cache.truncate_lane(
                        lane, int(self.cache.seq_lens[lane]))
                self.cache.seal_full_blocks(
                    lane, req.prompt + req.emitted + emit)
            # SLO latency accounting: the first emit is TTFT (queue wait
            # and prefill included); a later burst of m tokens closes m
            # TBT gaps of the mean inter-token time this step achieved.
            now = time.time()
            if req.produced == 0:
                obs.observe("inference_ttft_s", now - req.submitted)
            elif req.last_emit:
                for _ in range(m):
                    obs.observe("inference_tbt_s", (now - req.last_emit) / m)
            req.last_emit = now
            req.last_token = emit[-1]
            req.emitted.extend(emit)
            if lps is not None:
                req.logps.extend(float(lps[lane, j]) for j in range(m))
            req.produced += m
            if self._proposer is not None and not was_prefill:
                self._spec_stats["emitted"] += m
                self._spec_stats["bursts"] += 1
                obs.observe("inference_spec_tokens_per_step", m)
            if draft:
                self._spec_stats["drafted"] += len(draft)
                self._spec_stats["accepted"] += accepted
                obs.inc("inference_spec_drafted_tokens", len(draft))
                obs.inc("inference_spec_accepted_tokens", accepted)
                obs.record("engine", "spec_accept", trace=req.trace,
                           rid=req.rid, lane=lane, drafted=len(draft),
                           accepted=accepted, emitted=m)
                if self._spec_adaptive:
                    # Per-lane draft length: grow on full acceptance,
                    # halve on total rejection, otherwise track what
                    # the stream actually sustains.
                    if accepted == len(draft):
                        req.spec_k = min(self.spec_k, req.spec_k + 1)
                    elif accepted == 0:
                        req.spec_k = max(1, req.spec_k // 2)
                    else:
                        req.spec_k = max(1, min(req.spec_k, accepted + 1))
                self._proposer.observe(len(draft), accepted)
            # The consumer sees a burst as ONE item: no partial-draft
            # exposure.
            req.out.put(emit[0] if m == 1 else list(emit))
            if reason is None \
                    and int(self.cache.seq_lens[lane]) >= self.cache.max_seq_len:
                reason = "max_seq_len"
            if req.trace is not None:
                # Close the span ending at this emit (prefill for the
                # first token, the previous decode gap otherwise) and
                # open the next decode span unless the request is done.
                obs.end(req.span_tok, tokens=req.produced)
                req.span_tok = (
                    None if reason is not None else
                    obs.begin("engine", "decode", ctx=req.trace,
                              rid=req.rid, t=req.produced))
            if reason is not None:
                self._finish(lane, req, reason)
                obs.record("engine", "finish", trace=req.trace, rid=req.rid,
                           reason=reason, produced=req.produced)
