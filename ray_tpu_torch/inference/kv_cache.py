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

Not ported yet: the spill tier and the export/install of prefixes
(disaggregated serving).  `self.tier` stays None so that the chain walk
reads as in the reference.
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
                      "misses": 0, "sealed_blocks": 0}
        self.tier = None

    @classmethod
    def for_model(cls, model, config, **kw) -> "PagedKVCache":
        """Build a cache shaped for a models/ module."""
        kv_heads = getattr(config, "n_kv_heads", config.n_heads)
        kw.setdefault("max_seq_len", config.max_seq_len)
        kw.setdefault("dtype", config.dtype)
        return cls(config.n_layers, kv_heads, config.head_dim, **kw)

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
        `tokens`: ("dev", key, block) per device-resident sealed block
        (("tier", key, None) for a spilled one once a tier exists)."""
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
        """Admission check that accounts for reuse: matched blocks are
        referenced (not allocated), but matched blocks currently parked
        evictable stop counting as free capacity once taken."""
        dev = self.match_prefix(tokens)
        need = (self.blocks_needed(len(tokens)) - len(dev)
                + headroom_blocks)
        free_after = (self.allocator.num_free
                      - sum(self.allocator.is_evictable(b) for b in dev))
        return need <= free_after

    def adopt_prefix(self, lane: int, tokens: Sequence[int]) -> int:
        """Sequence start with prefix reuse: take shares of the longest
        cached prefix chain, allocate fresh blocks for the rest of the
        prompt, and report how many context tokens came from the cache
        (the engine skips prefilling them)."""
        if self._lane_blocks[lane]:
            raise ValueError(f"lane {lane} already allocated")
        if len(tokens) > self.max_seq_len:
            raise ValueError(f"prompt of {len(tokens)} exceeds max_seq_len "
                             f"{self.max_seq_len}")
        cached = self.match_prefix(tokens)
        # Take the shares FIRST so the fresh allocation below can never
        # evict a block this very request is about to reuse.
        for b in cached:
            self.allocator.incref(b)
        try:
            fresh = self.allocator.alloc(
                self.blocks_needed(len(tokens)) - len(cached))
        except RuntimeError:
            for b in cached:
                self.allocator.decref(b)
            raise
        cached_len = len(cached) * self.block_size
        self._install_lane(lane, cached + fresh, cached_len)
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
            self._lane_parent[lane] = hash(key)
            self._lane_sealed[lane] += 1

    def _on_evict(self, block: int) -> None:
        """Allocator reclaimed a cached block: drop its index entry.
        Children of the evicted chain node stay indexed but unreachable
        until an identical parent is re-sealed — at which point they are
        valid again by construction (content-addressed)."""
        key = self._block_key.pop(block, None)
        if key is not None and self._index.get(key) == block:
            del self._index[key]

    @property
    def num_indexed_blocks(self) -> int:
        return len(self._index)

    # ---------------- lane growth / teardown ----------------

    def ensure_capacity(self, lane: int, new_len: int) -> None:
        """Grow the lane's table as decode crosses block boundaries."""
        if new_len > self.max_seq_len:
            raise RuntimeError(f"lane {lane} exceeded max_seq_len")
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
        self._lane_blocks[lane] = []
        self.block_tables[lane, :] = 0
        self.seq_lens[lane] = 0
        self._lane_sealed[lane] = 0
        self._lane_parent[lane] = _ROOT_HASH
        self._dev_tables = None

    def lane_blocks(self, lane: int) -> List[int]:
        return list(self._lane_blocks[lane])

    # ---------------- device mirror ----------------

    def device_tables(self) -> torch.Tensor:
        """Block tables as an int32 tensor on the cache's device,
        uploaded again only after a host-side change."""
        if self._dev_tables is None:
            self._dev_tables = torch.from_numpy(self.block_tables.copy()).to(
                self.device)
        return self._dev_tables
