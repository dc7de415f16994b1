"""Tiered spill cache for refcount-0 sealed KV blocks (port of
ray_tpu/serve/kv_tier/tier.py).

Attached to a ``PagedKVCache`` (``cache.attach_tier``), this catches
blocks the allocator would otherwise destroy under pressure and keeps
their content reachable in SPILLED state:

  device pool ──evict──▶ host tier (numpy, LRU, bounded blocks)
                           │ overflow
                           ▼
                         store tier (an injected object store, else
                         spill files on disk; LRU, bounded blocks)
                           │ overflow
                           ▼
                         dropped for real (the only lossy edge)

``match/adopt`` restores spilled chains on hit.  All methods run under
the owning engine's lock; the tier itself takes none.

What the port does differently: the reference's store level puts to the
cluster's object store whenever `ray_tpu` is initialised in the process
(`ray_tpu.put` / `ray_tpu.get`).  The port imports no `ray_tpu`, so that
level is an injected ``store=(put, get)`` pair — `put(blob) -> handle`,
`get(handle) -> blob` — and with none given it spills to files under
``spill_dir``, as the reference does when no cluster is up.  Its counters
and events go to an injected ``Observer`` (util/observe.py) under the
reference's names.  Values are whatever the cache hands in (numpy
arrays; a bf16 pool's as their uint16 bits), pickled unchanged, so a
round trip is bit-exact in every dtype.
"""

from __future__ import annotations

import collections
import itertools
import os
import pickle
import tempfile
from typing import Callable, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.util.observe import NOOP, Observer


class KVTierCache:
    """Two LRU tiers keyed by the prefix index's content-addressed chain
    key ``(parent_hash, block_tokens)``.  Values are the block's K/V
    contents ``[n_layers, block_size, kv_heads, head_dim]`` per array,
    never quantized or truncated.  The defaults are the reference
    config's (`kv_tier_host_blocks` 256, `kv_tier_store_blocks` 1024)."""

    def __init__(self, host_blocks: int = 256, store_blocks: int = 1024,
                 spill_dir: Optional[str] = None,
                 store: Optional[Tuple[Callable, Callable]] = None,
                 observer: Optional[Observer] = None):
        self.host_blocks = max(int(host_blocks), 1)
        self.store_blocks = max(int(store_blocks), 0)
        self._host: "collections.OrderedDict[Tuple, Tuple]" = \
            collections.OrderedDict()          # key -> (k_np, v_np)
        self._store: "collections.OrderedDict[Tuple, Tuple]" = \
            collections.OrderedDict()          # key -> ("ref"|"file", handle)
        self._dir = spill_dir
        self._store_fns = store
        self._seq = itertools.count()
        self._obs = observer or NOOP
        self.counters = {"kv_tier_spilled_blocks": 0,
                         "kv_tier_restored_blocks": 0,
                         "kv_tier_dropped_blocks": 0}

    # ---------------- public surface (cache-facing) ----------------

    def __len__(self) -> int:
        return len(self._host) + len(self._store)

    def contains(self, key) -> bool:
        return key in self._host or key in self._store

    def put(self, key, k_np: np.ndarray, v_np: np.ndarray) -> None:
        """Spill one evicted block.  Newest entries win tier capacity;
        the overflow cascades host → store → dropped."""
        if self.contains(key):
            self._touch(key)
            return
        self._host[key] = (np.asarray(k_np), np.asarray(v_np))
        self._count("kv_tier_spilled_blocks", 1)
        self._obs.record("kv", "spilled", host=len(self._host),
                         store=len(self._store))
        while len(self._host) > self.host_blocks:
            old_key, (ko, vo) = self._host.popitem(last=False)
            self._demote(old_key, ko, vo)

    def pop(self, key) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Restore hit: hand the block's contents back (removing them —
        the caller re-indexes a device copy) or None if the key aged
        out since it was matched."""
        pair = self._host.pop(key, None)
        if pair is None:
            pair = self._store_pop(key)
        if pair is None:
            return None
        self._count("kv_tier_restored_blocks", 1)
        self._obs.record("kv", "restored", host=len(self._host),
                         store=len(self._store))
        return pair

    def discard(self, key) -> None:
        """The device index re-sealed identical content: the spilled
        copy is stale freight, not a drop worth counting."""
        if self._host.pop(key, None) is not None:
            return
        handle = self._store.pop(key, None)
        if handle is not None:
            self._release(handle)

    def summary_hashes(self) -> List[int]:
        """Cumulative chain hash of every spilled link, oldest first
        (mirrors the device index's seal-order summary)."""
        return [hash(k) for k in itertools.chain(self._store, self._host)]

    # ---------------- internals ----------------

    def _count(self, name: str, n: int) -> None:
        self.counters[name] += n
        self._obs.inc(name, n)

    def _touch(self, key) -> None:
        if key in self._host:
            self._host.move_to_end(key)
        elif key in self._store:
            self._store.move_to_end(key)

    def _demote(self, key, k_np, v_np) -> None:
        handle = self._store_put((k_np, v_np)) if self.store_blocks else None
        if handle is None:
            self._drop()
            return
        self._store[key] = handle
        while len(self._store) > self.store_blocks:
            _k, h = self._store.popitem(last=False)
            self._release(h)
            self._drop()

    def _drop(self) -> None:
        self._count("kv_tier_dropped_blocks", 1)
        self._obs.record("kv", "dropped", host=len(self._host),
                         store=len(self._store))

    def _store_put(self, pair) -> Optional[Tuple[str, object]]:
        """Second tier: the injected store when there is one, else (or
        when its put fails) a spill file on disk.  None means no second
        tier is available."""
        blob = pickle.dumps(pair, protocol=pickle.HIGHEST_PROTOCOL)
        if self._store_fns is not None:
            try:
                return ("ref", self._store_fns[0](blob))
            except Exception:
                pass            # store outage: fall through to disk
        try:
            if self._dir is None:
                self._dir = tempfile.mkdtemp(prefix="ray_tpu_torch_kv_tier_")
            path = os.path.join(self._dir, f"kv-{next(self._seq)}.bin")
            with open(path, "wb") as f:
                f.write(blob)
            return ("file", path)
        except OSError:
            return None

    def _store_pop(self, key) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        handle = self._store.pop(key, None)
        if handle is None:
            return None
        kind, h = handle
        try:
            if kind == "ref":
                blob = self._store_fns[1](h)
            else:
                with open(h, "rb") as f:
                    blob = f.read()
                os.unlink(h)
            return pickle.loads(blob)
        except Exception:
            return None         # store outage == cache miss, never an error

    def _release(self, handle) -> None:
        kind, h = handle
        if kind == "file":
            try:
                os.unlink(h)
            except OSError:
                pass
        # "ref": dropping the handle releases the store's object.
