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
device->host transfer is one int32 per lane — never the [B, V] logits.

The engine is host-driven: block allocation, admission and stream
fan-out are Python; the model math is one plain Python step function
per dispatched population (there is no jit), and it writes the new K/V
into the cache's pools IN PLACE (`index_copy_` in paged_kv_update).

Not ported yet: speculative decoding (`spec_k > 0`), behaviour log-prob
capture (`capture_logp=True`), the KV spill tier (`kv_tier=True`) with
prefix export/import, and the metrics/events/spans hooks; `stats()`
reports the engine's own counters.
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

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.inference import sampling
from ray_tpu_torch.inference.kv_cache import PagedKVCache

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
    fed: int = 0            # prompt tokens in the cache (prefilled OR reused)
    produced: int = 0
    last_token: int = 0
    emitted: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None

    @property
    def prefilling(self) -> bool:
        return self.fed < len(self.prompt)


class GenerationHandle:
    """Streaming view of one request: iterate to receive token ids as
    the engine emits them."""

    def __init__(self, req: _Request, engine: "InferenceEngine" = None):
        self._req = req
        self._engine = engine

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
        item = self._req.out.get()
        if item is _DONE:
            raise StopIteration
        return item

    def tokens(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the request finishes; returns all generated ids.

        `timeout` is an OVERALL deadline for the whole generation: if the
        request has not finished `timeout` seconds from this call, it is
        CANCELLED (its lane evicted) and TimeoutError is raised."""
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[int] = []
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
            out.append(item)

    @property
    def finish_reason(self) -> Optional[str]:
        return self._req.finish_reason


def _resolve_model(model):
    if isinstance(model, str):
        if model == "gpt":
            from ray_tpu_torch.models import gpt as mod
        elif model == "llama":
            from ray_tpu_torch.models import llama as mod
        else:
            raise ValueError(f"unknown model family {model!r} (the port "
                             f"serves 'gpt' and 'llama')")
        return mod
    return model  # a module implementing forward_cached/lm_head/CONFIGS


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
    """

    def __init__(self, model="gpt", config="nano", params=None, *,
                 max_lanes: int = 8, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 prefill_chunk: int = 32, seed: int = 0,
                 prefix_cache: bool = True, auto_start: bool = True,
                 spec_k: int = 0, kv_tier: Optional[bool] = None,
                 capture_logp: bool = False, device: DeviceLike = None):
        if spec_k > 0:
            raise NotImplementedError(
                "speculative decoding (spec_k > 0) is not ported yet: it "
                "comes with the speculative-decoding slice")
        if capture_logp:
            raise NotImplementedError(
                "capture_logp=True is not ported yet: it comes with the RL "
                "slice")
        if kv_tier:
            raise NotImplementedError(
                "kv_tier=True is not ported yet: it comes with the "
                "disaggregated-serving slice")
        self.device = resolve_device(device)
        self.model = _resolve_model(model)
        self.config = (self.model.CONFIGS[config] if isinstance(config, str)
                       else config)
        if params is None:
            params = self.model.init_params(
                self.config, torch.Generator().manual_seed(seed), self.device)
        self._set_params(params)
        self.max_lanes = max_lanes
        self.prefill_chunk = prefill_chunk
        self.seed = seed
        max_seq_len = min(max_seq_len or self.config.max_seq_len,
                          self.config.max_seq_len)
        if num_blocks is None:
            num_blocks = max_lanes * -(-max_seq_len // block_size)
        self.cache = PagedKVCache.for_model(
            self.model, self.config, num_blocks=num_blocks,
            block_size=block_size, max_lanes=max_lanes,
            max_seq_len=max_seq_len, prefix_cache=prefix_cache,
            device=self.device)
        self.policy_version = 0
        self._lanes: List[Optional[_Request]] = [None] * max_lanes
        self._waiting: "collections.deque[_Request]" = collections.deque()
        self._rid = itertools.count(1)
        self._steps = {"decode_steps": 0, "decode_seconds": 0.0,
                       "prefill_steps": 0, "prefill_seconds": 0.0}
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
               deadline_s: Optional[float] = None) -> GenerationHandle:
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
                                 else time.monotonic() + deadline_s))
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
            self._work.notify()
            return self.policy_version

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
                self._finish(None, req, "cancelled")
                return True
            for lane, r in enumerate(self._lanes):
                if r is req:
                    self._finish(lane, req, "cancelled")
                    return True
        return False

    def _finish(self, lane: Optional[int], req: _Request,
                reason: str) -> None:
        """End a request's stream and free its lane (caller holds the
        lock)."""
        req.finish_reason = reason
        req.out.put(_DONE)
        if lane is not None:
            self.cache.free_lane(lane)
            self._lanes[lane] = None

    def _expire_deadlines(self) -> None:
        """Evict every lane (and drop every queued request) whose
        deadline lapsed.  Caller holds the lock."""
        now = time.monotonic()
        for lane, req in enumerate(self._lanes):
            if req is not None and req.deadline is not None \
                    and now > req.deadline:
                self._finish(lane, req, "deadline")
        for req in [r for r in self._waiting
                    if r.deadline is not None and now > r.deadline]:
            self._waiting.remove(req)
            self._finish(None, req, "deadline")

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
        """Engine occupancy, prefix-cache counters and step counters
        (dispatches and host seconds per population, each ending in the
        step's one device->host transfer)."""
        cs = self.cache.stats
        return {
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
            "policy_version": self.policy_version,
            **self._steps,
        }

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
        the pool mid-flight."""
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
            req.fed = self.cache.adopt_prefix(lane, req.prompt)
            self._waiting.popleft()
            self._lanes[lane] = req

    def step(self) -> bool:
        """One scheduler iteration: admit, then advance every live lane.
        Decode lanes and prefilling lanes dispatch as SEPARATE steps
        (T=1 and T=prefill_chunk).  Returns False when fully idle."""
        with self._lock:
            self._expire_deadlines()
            self._admit()
            live = [(i, r) for i, r in enumerate(self._lanes)
                    if r is not None]
            if not live:
                return False
            plans = []
            decode = [(i, r) for i, r in live if not r.prefilling]
            if decode:
                plans.append(("decode", decode,
                              self._build_batch(decode, 1)))
            prefill = [(i, r) for i, r in live if r.prefilling]
            if prefill:
                plans.append(("prefill", prefill,
                              self._build_batch(prefill,
                                                self.prefill_chunk)))
            params = self._work_params
        done = []
        for kind, lanes, (batch, chunks) in plans:
            t0 = time.perf_counter()
            toks = self._run_step(params, *batch).cpu().numpy()
            self._steps[f"{kind}_steps"] += 1
            self._steps[f"{kind}_seconds"] += time.perf_counter() - t0
            done.append((lanes, chunks, toks))
        with self._work:
            for lanes, chunks, toks in done:
                self._commit(lanes, chunks, toks)
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
                chunk = 1
                tokens[lane, 0] = req.last_token
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
                  gather, temps, seeds, counters, sample):
        """The step function: cached forward (pools written in place),
        lm head on each lane's last valid position only, in-step
        sampling.  Returns int32 [max_lanes] on the device."""
        model, config = self.model, self.config
        x, _, _ = model.forward_cached(
            params, tokens, positions, valid, self.cache.k, self.cache.v,
            tables, ctx_lens, config)
        xg = x[torch.arange(x.shape[0], device=x.device), gather]  # [B, D]
        logits = model.lm_head(params, xg, config)                # [B, V]
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        if not sample:
            return greedy
        sampled = sampling.sample(logits, temps, seeds, counters)
        return torch.where(temps > 0, sampled, greedy)

    def _commit(self, live, chunks, toks):
        """Apply one dispatch's results: advance prefill cursors, seal
        newly-full blocks into the prefix index, stream the sampled
        token, finish + free lanes."""
        for lane, req in live:
            if self._lanes[lane] is not req:
                continue  # shutdown()/cancel() cleared the lane mid-step
            tok = int(toks[lane])
            if req.prefilling:
                req.fed += chunks[lane]
                self.cache.seq_lens[lane] += chunks[lane]
                self.cache.seal_full_blocks(lane, req.prompt)
                if req.prefilling:
                    continue  # more prompt to go; nothing sampled yet
            else:
                self.cache.seq_lens[lane] += 1
                self.cache.seal_full_blocks(
                    lane, req.prompt + req.emitted + [tok])
            req.last_token = tok
            req.emitted.append(tok)
            req.produced += 1
            req.out.put(tok)
            if req.eos_id is not None and tok == req.eos_id:
                reason = "eos"
            elif req.produced >= req.max_new_tokens:
                reason = "length"
            elif int(self.cache.seq_lens[lane]) >= self.cache.max_seq_len:
                reason = "max_seq_len"
            else:
                continue
            self._finish(lane, req, reason)
