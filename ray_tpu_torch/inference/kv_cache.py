"""Paged KV cache: fixed-size blocks in a preallocated device pool
(port of ray_tpu/inference/kv_cache.py).

The pool is [n_layers, num_blocks, block_size, kv_heads, head_dim] per
K and V, one torch allocation on the cache's device for the engine's
lifetime.  Each live sequence owns an ordered list of block ids; the
per-lane block tables map logical context positions onto pool blocks so
sequences of wildly different lengths pack the same pool with at most
block_size - 1 wasted slots each (the vLLM memory model).  Allocation
and free are host-side refcount operations.  Unlike the reference, the
pools are updated IN PLACE by the engine's step (`paged_kv_update`
writes into them), so there is nothing to rebind after a step.

Prefix caching (content-addressed block sharing): a block that has been
completely written ("sealed") is indexed by a hash chain over
(parent_hash, block_tokens) — the chain hash of a block is a function of
every token up to and including its own, and K/V at a position depend on
exactly that token prefix, so two sequences whose prefixes agree
block-for-block may share the physical blocks.  Sealed blocks are
immutable (decode writes always land past the sealed boundary), so
copy-on-write comes for free.  A finished sequence's sealed blocks stay
in the index at refcount 0 on an LRU list and are evicted only when the
allocator needs the space.

With a spill tier attached (`attach_tier`, serve/kv_tier/tier.py) an
evicted sealed block moves to host memory (then an injected store or
disk) instead of being destroyed, and the match / adopt path restores it
on a hit.  `export_prefix` / `install_prefix` ship a sealed chain from a
prefill engine to a decode engine (disaggregated serving), and
`prefix_summary` gives a router the chain hashes this cache can serve.
Restore and install write, in place, only into blocks they have just
allocated.  Host copies of a bf16 pool are its uint16 bits (numpy has no
bf16), so spills and frames round-trip bit-exactly; a float32 pool's
export is the reference's v1 payload.

A model that mixes sliding-window and full-attention layers keeps two
kinds of state side by side (`WindowPool`): the pool above holds the
full layers' K/V, every position of a lane; the window layers' K/V lives
in a pool of its own, where a lane holds only the blocks that a query
still to come can see (the last `window` positions and the chunk in
flight).  Its blocks are allocated as a lane's chunks advance and given
back as soon as the window has passed them, so that pool is sized by
lanes, not by context: `max_lanes` x `WindowPool.lane_cap` blocks.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device

# Root of every hash chain (a block with no parent).
_ROOT_HASH = 0


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of pool contents on the host: a bf16 tensor as its uint16
    bits (numpy has no bf16), anything else in its own dtype.  Never a
    view of the pool, which later steps overwrite."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(
            np.uint16)
    return t.to("cpu", copy=True).numpy()


def _from_host(arr: np.ndarray, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """The inverse of `_to_host`, on `device`."""
    arr = np.ascontiguousarray(arr)
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(dtype).to(device)
    return torch.from_numpy(arr).to(device)


def chain_hashes(tokens: Sequence[int], block_size: int) -> List[int]:
    """Cumulative chain hash of every block-aligned prefix of `tokens`,
    in the exact convention the prefix index uses (`hash((parent,
    block_tokens))`, root 0) and with the same one-token-left cap as
    match_prefix.  Tuple-of-int hashing is deterministic across
    processes (PYTHONHASHSEED randomizes str/bytes only)."""
    out: List[int] = []
    parent = _ROOT_HASH
    for i in range((len(tokens) - 1) // block_size):
        parent = hash((parent, tuple(int(t) for t in
                                     tokens[i * block_size:
                                            (i + 1) * block_size])))
        out.append(parent)
    return out


class BlockAllocator:
    """Refcounted free-list over pool block ids.

    Three states per block: free (no content), live (refcount >= 1) and
    evictable (refcount 0 but still holding indexed cached content —
    reusable without recompute, reclaimable under pressure).  `num_free`
    counts free + evictable: both are available capacity.  No implicit
    growth: exhaustion raises.
    """

    def __init__(self, num_blocks: int,
                 on_evict: Optional[Callable[[int], None]] = None):
        if num_blocks < 1:
            raise ValueError("need at least one block")
        self.num_blocks = num_blocks
        # LIFO: recently-freed blocks are re-used first.
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = [0] * num_blocks
        self._cached = [False] * num_blocks   # block holds indexed content
        # refcount-0 cached blocks, insertion order = LRU eviction order.
        self._evictable: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self.on_evict = on_evict
        self.evictions = 0

    @property
    def num_free(self) -> int:
        return len(self._free) + len(self._evictable)

    def can_alloc(self, n: int) -> bool:
        return n <= self.num_free

    def alloc(self, n: int = 1) -> List[int]:
        if n > self.num_free:
            raise RuntimeError(
                f"KV pool exhausted: want {n} blocks, {self.num_free} free")
        out = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                # Reclaim the least-recently-used cached block; the index
                # owner drops its entry via the eviction hook.
                b, _ = self._evictable.popitem(last=False)
                self._cached[b] = False
                self.evictions += 1
                if self.on_evict is not None:
                    self.on_evict(b)
            self._ref[b] = 1
            out.append(b)
        return out

    def incref(self, block: int) -> None:
        """Take a share of a cached block (prefix reuse)."""
        if self._ref[block] == 0:
            if block not in self._evictable:
                raise ValueError(f"incref of free block {block}")
            del self._evictable[block]
        self._ref[block] += 1

    def decref(self, block: int) -> None:
        """Drop one share.  At refcount 0 an indexed block parks on the
        LRU evictable list (content stays reusable); anything else goes
        straight back to the free list."""
        if self._ref[block] <= 0:
            raise ValueError(f"double free of block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            if self._cached[block]:
                self._evictable[block] = None    # most-recently-used end
            else:
                self._free.append(block)

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            self.decref(b)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def is_evictable(self, block: int) -> bool:
        return block in self._evictable

    def mark_cached(self, block: int) -> None:
        """The prefix index now references this block's content."""
        self._cached[block] = True


class WindowPool:
    """The window layers' K/V: pools [n_layers, num_blocks, block_size,
    kv_heads, head_dim] and per-lane block tables as wide as the full
    pool's (logical block i of a lane covers positions [i * block_size,
    (i + 1) * block_size)), of which a lane holds only the blocks that a
    query at or past its next position can see.

    A query at position p sees p - window < j <= p, so once the lane's
    next query is at position n, block i is invisible to every query to
    come when (i + 1) * block_size <= n - window + 1: `ensure` gives such
    blocks back before it allocates the step's, and their table entries
    return to 0, which the window's mask never lets a query read.  A
    lane then holds the blocks over [n - window + 1, n + chunk), at most
    `lane_cap` = ceil((window + chunk) / block_size) + 1 of them, and the
    pool has `max_lanes * lane_cap` blocks, which no admission can
    exhaust.  There is no prefix reuse here: a window block is one
    lane's alone."""

    def __init__(self, n_layers: int, kv_heads: int, head_dim: int, *,
                 window: int, chunk: int, block_size: int, max_lanes: int,
                 max_seq_len: int, dtype=torch.float32,
                 device: DeviceLike = None):
        if window < 1 or chunk < 1:
            raise ValueError(f"window {window} and chunk {chunk} must be >= 1")
        self.device = resolve_device(device)
        self.window = window
        self.block_size = block_size
        self.lane_cap = -(-(window + chunk) // block_size) + 1
        self.num_blocks = max_lanes * self.lane_cap
        shape = (n_layers, self.num_blocks, block_size, kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.allocator = BlockAllocator(self.num_blocks)
        self.block_tables = np.zeros(
            (max_lanes, math.ceil(max_seq_len / block_size)), np.int32)
        # Per lane: {logical block: pool block} of the blocks it holds.
        self._held: List[Dict[int, int]] = [{} for _ in range(max_lanes)]
        self._dev_tables: Optional[torch.Tensor] = None
        self.released = 0      # blocks given back, as passed or at lane end

    @property
    def resident(self) -> int:
        """Blocks held by lanes now."""
        return self.num_blocks - self.allocator.num_free

    def held(self, lane: int) -> int:
        return len(self._held[lane])

    def _drop(self, lane: int, blocks) -> None:
        held = self._held[lane]
        for i in blocks:
            self.allocator.decref(held.pop(i))
            self.block_tables[lane, i] = 0
            self.released += 1
            self._dev_tables = None

    def ensure(self, lane: int, start: int, new_len: int) -> None:
        """Before a step whose queries sit at [start, new_len): give back
        the blocks no query from `start` on can see, then hold every
        block over [start - window + 1, new_len)."""
        bs = self.block_size
        first = max(start - self.window + 1, 0) // bs
        held = self._held[lane]
        self._drop(lane, [i for i in held if i < first])
        missing = [i for i in range(first, math.ceil(new_len / bs))
                   if i not in held]
        # At most lane_cap a lane, so the pool's max_lanes x lane_cap
        # blocks are never exhausted and admission need not count them.
        assert len(held) + len(missing) <= self.lane_cap, (
            f"lane {lane} would hold {len(held) + len(missing)} window "
            f"blocks, more than {self.lane_cap}: steps of more than the "
            "chunk the pool was sized for")
        for i, b in zip(missing, self.allocator.alloc(len(missing))):
            held[i] = b
            self.block_tables[lane, i] = b
            self._dev_tables = None

    def free_lane(self, lane: int) -> None:
        self._drop(lane, list(self._held[lane]))

    def device_tables(self) -> torch.Tensor:
        if self._dev_tables is None:
            self._dev_tables = torch.from_numpy(self.block_tables.copy()).to(
                self.device)
        return self._dev_tables


class PagedKVCache:
    """Device pools + per-lane block tables for a fixed lane capacity.

    Host state (numpy block tables, sequence lengths, the allocator, the
    prefix index) is mirrored to the device lazily: `device_tables()`
    re-uploads only after a host-side change.
    """

    def __init__(self, n_layers: int, kv_heads: int, head_dim: int, *,
                 num_blocks: int, block_size: int, max_lanes: int,
                 max_seq_len: int, dtype=torch.float32,
                 prefix_cache: bool = True, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.block_size = block_size
        self.max_lanes = max_lanes
        self.max_seq_len = max_seq_len
        self.max_blocks_per_seq = math.ceil(max_seq_len / block_size)
        shape = (n_layers, num_blocks, block_size, kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.allocator = BlockAllocator(num_blocks, on_evict=self._on_evict)
        # Unused table entries stay 0 — always a valid pool index; the
        # attention mask (positions >= ctx_len) hides whatever lives there.
        self.block_tables = np.zeros((max_lanes, self.max_blocks_per_seq),
                                     np.int32)
        self.seq_lens = np.zeros((max_lanes,), np.int32)
        self._lane_blocks: List[List[int]] = [[] for _ in range(max_lanes)]
        self._dev_tables: Optional[torch.Tensor] = None
        # ---- prefix index (content-addressed sealed blocks) ----
        self.prefix_cache_enabled = prefix_cache
        # (parent_chain_hash, block_tokens) -> block id.
        self._index: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        self._block_key: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        self._lane_sealed = [0] * max_lanes     # sealed block count per lane
        self._lane_parent = [_ROOT_HASH] * max_lanes   # chain hash cursor
        self.stats = {"hit_tokens": 0, "miss_tokens": 0, "hits": 0,
                      "misses": 0, "sealed_blocks": 0, "imported_blocks": 0,
                      "restored_blocks": 0}
        # Optional spill tier: evicted sealed blocks move here instead of
        # being destroyed, and match / adopt restore them on a hit.
        self.tier = None
        # The window layers' pool, for a model that has them (for_model).
        self.window: Optional[WindowPool] = None

    def attach_tier(self, tier) -> None:
        """Attach a spill tier (duck-typed: contains/put/pop/discard/
        summary_hashes/__len__).  Evictions start spilling immediately;
        match/adopt start seeing spilled chains."""
        self.tier = tier

    @classmethod
    def for_model(cls, model, config, *, prefill_chunk: int = 1,
                  **kw) -> "PagedKVCache":
        """Build a cache shaped for a models/ module.  A config with
        window layers (`n_window_layers`, `sliding_window`) gets this
        pool for its full layers and a `WindowPool` for the others, sized
        for steps of at most `prefill_chunk` tokens a lane; prefix reuse
        is then off."""
        kv_heads = getattr(config, "n_kv_heads", config.n_heads)
        kw.setdefault("max_seq_len", config.max_seq_len)
        kw.setdefault("dtype", config.dtype)
        n_window = getattr(config, "n_window_layers", 0)
        if n_window:
            kw["prefix_cache"] = False
        cache = cls(config.n_layers - n_window, kv_heads, config.head_dim,
                    **kw)
        if n_window:
            cache.window = WindowPool(
                n_window, kv_heads, config.head_dim,
                window=config.sliding_window, chunk=prefill_chunk,
                block_size=cache.block_size, max_lanes=cache.max_lanes,
                max_seq_len=cache.max_seq_len, dtype=kw["dtype"],
                device=cache.device)
        return cache

    def pools(self) -> tuple:
        """(K, V) as a model's cached forward takes them: the pools, or
        with a window pool the pairs (full, window)."""
        if self.window is None:
            return self.k, self.v
        return (self.k, self.window.k), (self.v, self.window.v)

    # ---------------- host-side lane lifecycle ----------------

    def blocks_needed(self, seq_len: int) -> int:
        return math.ceil(max(seq_len, 1) / self.block_size)

    def alloc_lane(self, lane: int, prompt_len: int) -> None:
        """Sequence start without prefix reuse: claim fresh blocks
        covering the prompt."""
        if self._lane_blocks[lane]:
            raise ValueError(f"lane {lane} already allocated")
        if prompt_len > self.max_seq_len:
            raise ValueError(f"prompt of {prompt_len} exceeds max_seq_len "
                             f"{self.max_seq_len}")
        blocks = self.allocator.alloc(self.blocks_needed(prompt_len))
        self._install_lane(lane, blocks, cached_len=0)

    def _install_lane(self, lane: int, blocks: List[int],
                      cached_len: int) -> None:
        self._lane_blocks[lane] = blocks
        self.block_tables[lane, :len(blocks)] = blocks
        self.seq_lens[lane] = cached_len
        self._lane_sealed[lane] = cached_len // self.block_size
        self._lane_parent[lane] = _ROOT_HASH
        self._dev_tables = None

    # ---------------- prefix cache ----------------

    def match_prefix(self, tokens: Sequence[int]) -> List[int]:
        """Longest chain of cached sealed blocks covering a block-aligned
        prefix of `tokens`, capped so at least one prompt token is always
        left to prefill (its logits seed the first sampled token).  Pure
        lookup — takes no references."""
        if not self.prefix_cache_enabled:
            return []
        out: List[int] = []
        for kind, _key, block in self._match_chain(tokens):
            if kind != "dev":
                break
            out.append(block)
        return out

    def _match_chain(self, tokens: Sequence[int]) -> List[Tuple]:
        """Longest cached chain covering a block-aligned prefix of
        `tokens`, walking THROUGH the spill tier: ("dev", key, block) for
        a device-resident sealed block, ("tier", key, None) for a spilled
        one (restorable on adopt).  A device child behind a spilled
        parent is reachable again: the chain is content-addressed."""
        if not self.prefix_cache_enabled:
            return []
        bs = self.block_size
        out: List[Tuple] = []
        parent = _ROOT_HASH
        for i in range((len(tokens) - 1) // bs):
            key = (parent, tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
            block = self._index.get(key)
            if block is not None:
                out.append(("dev", key, block))
            elif self.tier is not None and self.tier.contains(key):
                out.append(("tier", key, None))
            else:
                break
            parent = hash(key)
        return out

    def can_admit_prefix(self, tokens: Sequence[int],
                         headroom_blocks: int = 0) -> bool:
        """Admission check that accounts for reuse: device-matched blocks
        are referenced (not allocated), but matched blocks currently
        parked evictable stop counting as free capacity once taken.
        Spilled matches still cost an allocation (they restore into
        fresh blocks), so they stay inside `need`."""
        dev = [b for kind, _k, b in self._match_chain(tokens)
               if kind == "dev"]
        need = (self.blocks_needed(len(tokens)) - len(dev)
                + headroom_blocks)
        free_after = (self.allocator.num_free
                      - sum(self.allocator.is_evictable(b) for b in dev))
        return need <= free_after

    def adopt_prefix(self, lane: int, tokens: Sequence[int]) -> int:
        """Sequence start with prefix reuse: take shares of the longest
        cached prefix chain (restoring any spilled links from the tier),
        allocate fresh blocks for the rest of the prompt, and report how
        many context tokens came from the cache (the engine skips
        prefilling them)."""
        if self._lane_blocks[lane]:
            raise ValueError(f"lane {lane} already allocated")
        if len(tokens) > self.max_seq_len:
            raise ValueError(f"prompt of {len(tokens)} exceeds max_seq_len "
                             f"{self.max_seq_len}")
        entries = self._match_chain(tokens)
        # Pop spilled payloads out of the tier FIRST: once held here, the
        # allocations below can spill other blocks into the tier without
        # LRU pressure dropping the very chain being restored.  A pop that
        # misses (aged out since the match) truncates the usable chain at
        # the hole — later links have no K/V under them.
        restores = []       # (key, (k_host, v_host)) in chain order
        for pos, (kind, key, _b) in enumerate(entries):
            if kind != "tier":
                continue
            payload = self.tier.pop(key)
            if payload is None:
                entries = entries[:pos]
                break
            restores.append((key, payload))
        dev_blocks = [b for kind, _k, b in entries if kind == "dev"]
        # Take the device shares FIRST so the fresh allocation below can
        # never evict a block this very request is about to reuse.
        for b in dev_blocks:
            self.allocator.incref(b)
        try:
            fresh = self.allocator.alloc(
                self.blocks_needed(len(tokens)) - len(dev_blocks))
        except RuntimeError:
            for b in dev_blocks:
                self.allocator.decref(b)
            for key, (k_host, v_host) in restores:
                self.tier.put(key, k_host, v_host)      # undo the pops
            raise
        # The lane's blocks in chain order: device hits keep their
        # blocks, spilled hits take fresh ones (their contents are
        # written in below), the prompt tail takes the rest.
        fresh_iter = iter(fresh)
        cached = [b if kind == "dev" else next(fresh_iter)
                  for kind, _k, b in entries]
        tail = list(fresh_iter)
        if restores:
            restored = [b for b, (kind, _k, _b) in zip(cached, entries)
                        if kind == "tier"]
            self._write_blocks(restored,
                               np.stack([p[0] for _k, p in restores], 1),
                               np.stack([p[1] for _k, p in restores], 1))
            for nb, (key, _p) in zip(restored, restores):
                # Restored blocks re-enter the device index (live now,
                # evictable again once the lane lets go).
                self._index[key] = nb
                self._block_key[nb] = key
                self.allocator.mark_cached(nb)
                self.stats["restored_blocks"] += 1
        cached_len = len(cached) * self.block_size
        self._install_lane(lane, cached + tail, cached_len)
        if cached:
            # Rebuild the chain cursor at the sealed boundary so blocks
            # sealed later extend the same chain.
            self._lane_parent[lane] = chain_hashes(
                tokens[:cached_len + 1], self.block_size)[-1]
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += cached_len
        else:
            self.stats["misses"] += 1
        self.stats["miss_tokens"] += len(tokens) - cached_len
        return cached_len

    def seal_full_blocks(self, lane: int, tokens: Sequence[int]) -> None:
        """Index every newly-full block of this lane.  `tokens` is the
        lane's full token sequence (prompt + generated); only the first
        seq_lens[lane] of them have K/V in the pool, and a block seals
        the moment the write cursor crosses its end — mid-prefill too."""
        if not self.prefix_cache_enabled:
            return
        bs = self.block_size
        full = int(self.seq_lens[lane]) // bs
        blocks = self._lane_blocks[lane]
        while self._lane_sealed[lane] < full:
            i = self._lane_sealed[lane]
            key = (self._lane_parent[lane],
                   tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
            block = blocks[i]
            # First writer wins: if an identical block is already indexed
            # this one stays un-indexed freight (freed normally later);
            # an adopted shared block re-seals as itself (no-op).
            if key not in self._index and block not in self._block_key:
                self._index[key] = block
                self._block_key[block] = key
                self.allocator.mark_cached(block)
                self.stats["sealed_blocks"] += 1
                if self.tier is not None:
                    # Re-sealed on device: the spilled copy is stale
                    # freight now (content-addressed, so identical).
                    self.tier.discard(key)
            self._lane_parent[lane] = hash(key)
            self._lane_sealed[lane] += 1

    def _on_evict(self, block: int) -> None:
        """Allocator reclaimed a cached block: drop its index entry —
        spilling the content into the attached tier first, so the chain
        link survives eviction in SPILLED state.  The copy to the host is
        synchronous and happens inside `alloc`, before the block is handed
        out, so no later write to the block can overtake it.  Without a
        tier, children of the evicted chain node stay indexed but
        unreachable until an identical parent is re-sealed — at which
        point they are valid again by construction (content-addressed)."""
        key = self._block_key.pop(block, None)
        if key is not None and self._index.get(key) == block:
            del self._index[key]
            if self.tier is not None:
                self.tier.put(key, _to_host(self.k[:, block]),
                              _to_host(self.v[:, block]))

    @property
    def num_indexed_blocks(self) -> int:
        return len(self._index)

    def _write_blocks(self, blocks: List[int], k_host: np.ndarray,
                      v_host: np.ndarray) -> None:
        """Write host K/V [n_layers, len(blocks), ...] into pool blocks,
        in place.  Callers pass only blocks they have just allocated,
        which no live lane's step reads or writes."""
        idx = torch.tensor(blocks, dtype=torch.int64, device=self.device)
        for pool, arr in ((self.k, k_host), (self.v, v_host)):
            pool.index_copy_(1, idx, _from_host(arr, pool.dtype, self.device))

    # ---------------- disaggregated handoff / summaries ----------------

    def export_prefix(self, tokens: Sequence[int]) -> Optional[dict]:
        """Snapshot the longest DEVICE-cached chain covering a
        block-aligned prefix of `tokens` as a codec payload: chain
        token-blocks plus gathered K/V contents, enough for a foreign
        cache to rebuild the same content-addressed links.  A float32
        pool gives the reference's v1 payload; a bf16 pool a v2 payload
        (`dtype` "bfloat16", K/V as uint16 bits).  None when nothing is
        cached."""
        entries = []
        for kind, key, block in self._match_chain(tokens):
            if kind != "dev":
                break           # spilled links don't ship (restore is local)
            entries.append((key, block))
        if not entries:
            return None
        idx = torch.tensor([b for _k, b in entries], dtype=torch.int64,
                           device=self.device)
        payload = {
            "v": 1,
            "block_size": self.block_size,
            "chain": [list(key[1]) for key, _b in entries],
            "k": _to_host(self.k.index_select(1, idx)),
            "v_pool": _to_host(self.v.index_select(1, idx)),
        }
        if self.k.dtype == torch.bfloat16:
            payload = {"v": 2, "dtype": "bfloat16",
                       **{n: payload[n] for n in ("block_size", "chain", "k",
                                                  "v_pool")}}
        return payload

    def _frame_fits(self, payload: dict) -> bool:
        """The payload's version, dtype and shapes are this pool's: a v2
        payload of uint16 bits for a bf16 pool, a v1 payload of the pool's
        own numpy dtype otherwise.  Stricter than the reference, whose
        install checks shapes only and would cast another dtype."""
        k_arr, v_arr = payload["k"], payload["v_pool"]
        if self.k.dtype == torch.bfloat16:
            ok = (payload.get("v") == 2 and payload.get("dtype") == "bfloat16"
                  and k_arr.dtype == v_arr.dtype == np.uint16)
        else:
            want = torch.empty(0, dtype=self.k.dtype).numpy().dtype
            ok = payload.get("v") == 1 and k_arr.dtype == v_arr.dtype == want
        return (ok and payload.get("block_size") == self.block_size
                and k_arr.shape == v_arr.shape
                and k_arr.shape[0] == self.k.shape[0]
                and tuple(k_arr.shape[2:]) == tuple(self.k.shape[2:]))

    def install_prefix(self, payload: dict) -> int:
        """Adopt foreign sealed blocks (the prefill→decode handoff): for
        each shipped chain node not already present locally, allocate a
        block, write the shipped K/V into it, and index it at refcount 0
        (evictable) — a subsequent adopt_prefix on the same prompt then
        takes shares exactly as if the blocks had been sealed here.
        Content-addressed and idempotent: repeating the import after a
        failover is a no-op for links already present.  A payload of
        another version, dtype, block size or model shape installs
        nothing.  Returns how many blocks were installed."""
        if not self.prefix_cache_enabled or not payload:
            return 0
        if not self._frame_fits(payload):
            return 0
        parent = _ROOT_HASH
        new = []                # (chain_pos, key, block)
        for i, blk_tokens in enumerate(payload["chain"]):
            key = (parent, tuple(int(t) for t in blk_tokens))
            present = (key in self._index
                       or (self.tier is not None
                           and self.tier.contains(key)))
            if not present:
                try:
                    # May evict LRU cached blocks (new prefix beats old)
                    # but never steals live capacity: alloc raises only
                    # when everything is referenced, and we stop there.
                    (b,) = self.allocator.alloc(1)
                except RuntimeError:
                    break
                new.append((i, key, b))
            parent = hash(key)
        if not new:
            return 0
        pos = np.asarray([i for i, _k, _b in new])
        self._write_blocks([b for _i, _k, b in new], payload["k"][:, pos],
                           payload["v_pool"][:, pos])
        # Index + park evictable only AFTER every alloc: the blocks stay
        # at refcount 1 through the loop above so a later alloc in the
        # same import can never reclaim an earlier install.
        for _i, key, b in new:
            self._index[key] = b
            self._block_key[b] = key
            self.allocator.mark_cached(b)
            self.allocator.decref(b)
            self.stats["imported_blocks"] += 1
        return len(new)

    def prefix_summary(self, limit: int = 256) -> dict:
        """Compact routing summary: the cumulative chain hashes of every
        sealed block this cache can serve (device index + spill tier),
        newest last, capped at `limit`.  A router holding the request's
        own chain hashes scores this replica by deepest overlap without
        ever shipping tokens."""
        hashes = [hash(k) for k in self._block_key.values()]
        if self.tier is not None:
            hashes.extend(self.tier.summary_hashes())
        # Order-preserving dedup; newest sealed blocks win the cap.
        hashes = list(dict.fromkeys(hashes))[-max(int(limit), 1):]
        return {
            "v": 1,
            "block_size": self.block_size,
            "hashes": hashes,
            "indexed_blocks": len(self._index),
            "tier_blocks": 0 if self.tier is None else len(self.tier),
        }

    # ---------------- lane growth / teardown ----------------

    def ensure_capacity(self, lane: int, new_len: int) -> None:
        """Grow the lane's table as decode crosses block boundaries; with
        a window pool, also move the lane's window up to the step whose
        queries start at its current length (`WindowPool.ensure`)."""
        if new_len > self.max_seq_len:
            raise RuntimeError(f"lane {lane} exceeded max_seq_len")
        if self.window is not None:
            self.window.ensure(lane, int(self.seq_lens[lane]), new_len)
        need = self.blocks_needed(new_len)
        blocks = self._lane_blocks[lane]
        while len(blocks) < need:
            (b,) = self.allocator.alloc(1)
            self.block_tables[lane, len(blocks)] = b
            blocks.append(b)
            self._dev_tables = None

    def truncate_lane(self, lane: int, new_len: int) -> None:
        """Release the table-tail blocks past what `new_len` committed
        tokens need (speculative rollback).  Only wholly-uncommitted tail
        blocks go — always fresh, exclusively-owned allocations, since
        the sealed boundary never passes the committed length."""
        blocks = self._lane_blocks[lane]
        keep = max(self.blocks_needed(new_len), self._lane_sealed[lane])
        while len(blocks) > keep:
            b = blocks.pop()
            self.allocator.decref(b)
            self.block_tables[lane, len(blocks)] = 0
            self._dev_tables = None

    def free_lane(self, lane: int) -> None:
        """Sequence finish: drop this lane's share of every block.
        Sealed+indexed blocks whose refcount hits 0 park on the LRU
        evictable list; everything else returns to the free list."""
        for b in self._lane_blocks[lane]:
            self.allocator.decref(b)
        if self.window is not None:
            self.window.free_lane(lane)
        self._lane_blocks[lane] = []
        self.block_tables[lane, :] = 0
        self.seq_lens[lane] = 0
        self._lane_sealed[lane] = 0
        self._lane_parent[lane] = _ROOT_HASH
        self._dev_tables = None

    def lane_blocks(self, lane: int) -> List[int]:
        return list(self._lane_blocks[lane])

    # ---------------- device mirror ----------------

    def device_tables(self):
        """Block tables as an int32 tensor on the cache's device,
        uploaded again only after a host-side change; with a window pool
        the pair (full, window), as `pools`."""
        if self._dev_tables is None:
            self._dev_tables = torch.from_numpy(self.block_tables.copy()).to(
                self.device)
        if self.window is not None:
            return self._dev_tables, self.window.device_tables()
        return self._dev_tables
