"""The port's paged KV cache bookkeeping (ray_tpu_torch/inference/kv_cache.py)
against the JAX reference's: the same sequence of lane operations must
leave the same block tables, sequence lengths, allocator state, prefix
index and counters, and the chain hashes must agree."""

import numpy as np
import pytest
import torch

from ray_tpu.inference import kv_cache as jkv
from ray_tpu_torch.inference import kv_cache as tkv

# Tiny tensors: one thread each keeps the parallel test workers from
# oversubscribing the host's cores.
torch.set_num_threads(1)

CACHE_KW = dict(n_layers=1, kv_heads=1, head_dim=4, block_size=4,
                max_lanes=3, max_seq_len=32)


def _pair(num_blocks, prefix_cache=True):
    return (jkv.PagedKVCache(num_blocks=num_blocks, prefix_cache=prefix_cache,
                             **CACHE_KW),
            tkv.PagedKVCache(num_blocks=num_blocks, prefix_cache=prefix_cache,
                             device="cpu", **CACHE_KW))


def _state(cache):
    a = cache.allocator
    return dict(tables=cache.block_tables.tolist(),
                seq_lens=cache.seq_lens.tolist(),
                lanes=[cache.lane_blocks(i) for i in range(cache.max_lanes)],
                free=a.num_free, evictions=a.evictions,
                refs=[a.refcount(b) for b in range(a.num_blocks)],
                evictable=[a.is_evictable(b) for b in range(a.num_blocks)],
                indexed=cache.num_indexed_blocks,
                stats={k: cache.stats[k] for k in ("hits", "misses",
                                                   "hit_tokens",
                                                   "miss_tokens",
                                                   "sealed_blocks")})


def _script(cache, toks):
    """A lane lifecycle touching every bookkeeping path; returns what
    each step reported, for comparison."""
    out = []
    out.append(cache.adopt_prefix(0, toks[:13]))           # miss, 4 blocks
    cache.seq_lens[0] = 13
    cache.seal_full_blocks(0, toks[:13])                   # seals 3
    out.append(cache.match_prefix(toks[:13] + [7]))
    out.append(cache.can_admit_prefix(toks[:14], headroom_blocks=2))
    out.append(cache.adopt_prefix(1, toks[:14]))           # hit, 12 tokens
    cache.ensure_capacity(1, 21)                           # grows to 6
    cache.truncate_lane(1, 17)                             # back to 5
    out.append(cache.adopt_prefix(2, [9] * 9))             # miss, 3 blocks
    cache.free_lane(0)
    cache.free_lane(1)                                     # sealed park
    cache.free_lane(2)
    # A 32-token request claims 8 blocks: past the plain free list the
    # LRU cached blocks are evicted and their index entries dropped.
    out.append(cache.adopt_prefix(0, list(range(100, 132))))
    out.append(cache.match_prefix(toks[:13] + [7]))
    out.append(tuple(cache.device_tables().tolist()[0]))
    return out


# Pool sizes that make the final request evict cached blocks (with the
# prefix cache) or just fit (without it).
@pytest.mark.parametrize("prefix_cache,num_blocks", [(True, 10), (False, 12)])
def test_cache_bookkeeping_matches_reference(prefix_cache, num_blocks):
    toks = np.random.default_rng(0).integers(0, 50, 20).tolist()
    jc, tc = _pair(num_blocks, prefix_cache)
    assert _script(tc, toks) == _script(jc, toks)
    assert _state(tc) == _state(jc)
    assert isinstance(tc.device_tables(), torch.Tensor)
    assert tc.device_tables().dtype == torch.int32


def test_chain_hashes_match_reference():
    toks = list(range(1, 40))
    for bs in (1, 4, 8, 16):
        assert tkv.chain_hashes(toks, bs) == jkv.chain_hashes(toks, bs)


def test_allocator_matches_reference_under_eviction():
    evicted = {"j": [], "t": []}
    ja = jkv.BlockAllocator(4, on_evict=evicted["j"].append)
    ta = tkv.BlockAllocator(4, on_evict=evicted["t"].append)
    for a in (ja, ta):
        b = a.alloc(3)
        a.mark_cached(b[0])
        a.mark_cached(b[2])
        a.free(b)
        a.incref(b[2])
        got = a.alloc(3)
        a.free(got + [b[2]])
        with pytest.raises(RuntimeError, match="exhausted"):
            a.alloc(5)
        with pytest.raises(ValueError, match="double free"):
            a.decref(got[0])
    assert evicted["t"] == evicted["j"] and ta.evictions == ja.evictions
    assert ta._free == ja._free
    assert list(ta._evictable) == list(ja._evictable)
