"""The port's KV spill tier, frame codec and cache handoff hooks
(ray_tpu_torch/serve/kv_tier/, inference/kv_cache.py) against the JAX
reference's on the same inputs:

- the codec: bit-exact round trips in f32 and bf16; the port's f32
  frame is byte for byte the reference's; a JAX f32 frame and a JAX bf16
  frame (ml_dtypes arrays) decode in the port to the same bits; a port
  bf16 frame (v2) is a miss for the reference; garbage is a miss;
- the tier: one sequence of put/pop/discard gives the reference's
  counters, summaries and LRU victims, over disk and over an injected
  store, and bit-exact values in every dtype;
- the cache: one script of lane operations with a tier attached (seal,
  spill, restore, a failed adopt undone, an install under eviction
  pressure, export, summary) leaves the reference's state and pool
  contents; engines on shared nano weights give the reference's tokens,
  stats and summaries through spill and restore, conserve the pool, and
  pop a spilled chain before their own allocation can drop it."""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference import InferenceEngine as JaxEngine
from ray_tpu.inference import kv_cache as jkv
from ray_tpu.models import gpt as jgpt
from ray_tpu.serve import kv_tier as jtier
from ray_tpu.serve._private import _chain_hashes
from ray_tpu_torch.inference import InferenceEngine
from ray_tpu_torch.inference import kv_cache as tkv
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve.kv_tier import KVBlockCodec, KVCodecError, KVTierCache

# Tiny tensors: one thread each keeps the parallel test workers from
# oversubscribing the host's cores.
torch.set_num_threads(1)

_WEIGHTS: dict = {}
_STEP_FNS: dict = {}


def nano_weights():
    """(reference params, the port's params) of gpt nano, seed 0."""
    if not _WEIGHTS:
        jparams = jgpt.init_params(jgpt.CONFIGS["nano"], jax.random.key(0))
        _WEIGHTS["nano"] = (jparams, params_from_numpy(
            jax.tree.map(np.asarray, jparams), gpt.CONFIGS["nano"],
            device="cpu"))
    return _WEIGHTS["nano"]


def jax_engine(**kw):
    """A JAX nano engine on the shared weights.  Its jitted step
    functions depend only on the model and config, so every engine of a
    test process shares one table of them: each step shape compiles
    once."""
    eng = JaxEngine("gpt", "nano", params=nano_weights()[0],
                    auto_start=False, **kw)
    eng._step_fns = _STEP_FNS.setdefault("nano", eng._step_fns)
    return eng


def port_engine(**kw):
    return InferenceEngine("gpt", "nano", params=nano_weights()[1],
                           device="cpu", auto_start=False, **kw)


def ref_keys_equal(port_stats, ref_stats):
    """Every key the reference's stats() has, with its value."""
    return {k: port_stats[k] for k in ref_stats} == ref_stats


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------

CACHE_KW = dict(n_layers=2, kv_heads=2, head_dim=4, block_size=4,
                max_lanes=3, max_seq_len=32)


def _seal(cache, lane, toks):
    """Adopt `toks` into `lane`, mark them written and seal the full
    blocks (what a prefill step does to the bookkeeping)."""
    cache.adopt_prefix(lane, toks)
    cache.seq_lens[lane] = len(toks)
    cache.seal_full_blocks(lane, toks)


def _port_cache(dtype, seed=0, **kw):
    """A port cache whose pools hold random values of `dtype`."""
    cache = tkv.PagedKVCache(num_blocks=8, dtype=dtype, device="cpu",
                             **{**CACHE_KW, **kw})
    gen = torch.Generator().manual_seed(seed)
    for pool in (cache.k, cache.v):
        pool.copy_(torch.randn(pool.shape, generator=gen))
    return cache


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16) \
        if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_codec_roundtrip_bit_exact(dtype):
    cache = _port_cache(dtype)
    toks = list(range(1, 14))
    _seal(cache, 0, toks)
    payload = cache.export_prefix(toks)
    blob = KVBlockCodec.encode(payload)
    out = KVBlockCodec.decode(blob)
    assert out["chain"] == [toks[i:i + 4] for i in (0, 4, 8)]
    blocks = cache.lane_blocks(0)[:3]
    for key, pool in (("k", cache.k), ("v_pool", cache.v)):
        want = _bits(pool[:, blocks])
        assert out[key].dtype == want.dtype
        np.testing.assert_array_equal(out[key], want)
    if dtype == torch.float32:
        # The reference's v1 frame, byte for byte, and both decoders
        # read it.
        assert out["v"] == 1 and "dtype" not in out
        assert blob == jtier.KVBlockCodec.encode(payload)
        ref = jtier.KVBlockCodec.decode(blob)
        np.testing.assert_array_equal(ref["k"], out["k"])
    else:
        assert out["v"] == 2 and out["dtype"] == "bfloat16"


def _jax_export(dtype):
    """A reference cache with random pools of `dtype`, one sealed 3-block
    chain, and its export_prefix payload."""
    cache = jkv.PagedKVCache(num_blocks=8, dtype=dtype, **CACHE_KW)
    key = jax.random.key(3)
    cache.k = jax.random.normal(key, cache.k.shape).astype(dtype)
    cache.v = jax.random.normal(jax.random.fold_in(key, 1),
                                cache.v.shape).astype(dtype)
    toks = list(range(5, 18))
    _seal(cache, 0, toks)
    return toks, cache.export_prefix(toks)


def test_jax_f32_frame_decodes_in_the_port():
    toks, payload = _jax_export(jnp.float32)
    out = KVBlockCodec.decode(jtier.KVBlockCodec.encode(payload))
    assert out["v"] == 1 and out["chain"] == payload["chain"]
    for key in ("k", "v_pool"):
        assert out[key].dtype == np.float32
        np.testing.assert_array_equal(out[key], payload[key])
    # Installed in a port cache, then exported again: the same values.
    cache = tkv.PagedKVCache(num_blocks=8, device="cpu", **CACHE_KW)
    assert cache.install_prefix(out) == 3
    again = cache.export_prefix(toks)
    np.testing.assert_array_equal(again["k"], payload["k"])


def test_jax_bf16_frame_reads_bit_exact():
    """A bf16 JAX pool exports ml_dtypes arrays in a v1 frame; the port
    reads them as the same bits (v2 form) and installs them into a bf16
    pool bit for bit."""
    toks, payload = _jax_export(jnp.bfloat16)
    assert payload["k"].dtype.name == "bfloat16"
    out = KVBlockCodec.decode(jtier.KVBlockCodec.encode(payload))
    assert out["v"] == 2 and out["dtype"] == "bfloat16"
    for key in ("k", "v_pool"):
        assert out[key].dtype == np.uint16
        np.testing.assert_array_equal(out[key],
                                      payload[key].view(np.uint16))
    cache = tkv.PagedKVCache(num_blocks=8, dtype=torch.bfloat16,
                             device="cpu", **CACHE_KW)
    assert cache.install_prefix(out) == 3
    got = cache.export_prefix(toks)
    np.testing.assert_array_equal(got["k"], payload["k"].view(np.uint16))
    np.testing.assert_array_equal(got["v_pool"],
                                  payload["v_pool"].view(np.uint16))


def test_port_bf16_frame_is_a_miss_for_the_reference():
    cache = _port_cache(torch.bfloat16)
    toks = list(range(1, 14))
    _seal(cache, 0, toks)
    payload = cache.export_prefix(toks)
    blob = KVBlockCodec.encode(payload)
    assert jtier.KVBlockCodec.try_decode(blob) is None
    ref_cache = jkv.PagedKVCache(num_blocks=8, dtype=jnp.bfloat16,
                                 **CACHE_KW)
    assert ref_cache.install_prefix(payload) == 0


def test_codec_rejects_garbage():
    cache = _port_cache(torch.float32)
    toks = list(range(1, 14))
    _seal(cache, 0, toks)
    payload = cache.export_prefix(toks)
    blob = KVBlockCodec.encode(payload)
    with pytest.raises(KVCodecError, match="v1 or v2"):
        KVBlockCodec.encode({"v": 3})
    with pytest.raises(KVCodecError, match="uint16 bits"):
        KVBlockCodec.encode({**payload, "v": 2, "dtype": "bfloat16"})
    with pytest.raises(KVCodecError, match="bytes"):
        KVBlockCodec.decode(12345)
    with pytest.raises(KVCodecError, match="magic"):
        KVBlockCodec.decode(b"NOPE" + blob[4:])
    with pytest.raises(KVCodecError, match="corrupt"):
        KVBlockCodec.decode(blob[:len(blob) // 2])
    with pytest.raises(KVCodecError, match="shape mismatch"):
        KVBlockCodec.decode(b"KVT1" + pickle.dumps(
            {**payload, "chain": payload["chain"][:-1]}))
    with pytest.raises(KVCodecError, match="version"):
        KVBlockCodec.decode(b"KVT1" + pickle.dumps({**payload, "v": 3}))
    with pytest.raises(KVCodecError, match="v2 frame"):
        KVBlockCodec.decode(b"KVT1" + pickle.dumps(
            {**payload, "v": 2, "dtype": "bfloat16"}))
    with pytest.raises(KVCodecError, match="dtype"):
        KVBlockCodec.decode(b"KVT1" + pickle.dumps(
            {**payload, "k": payload["k"].astype(np.int32)}))
    for bad in (b"garbage", b"KVT1", blob[:-7], b"KVT1" + pickle.dumps([1])):
        assert KVBlockCodec.try_decode(bad) is None
    assert KVBlockCodec.try_decode(blob)["chain"] == payload["chain"]


# ---------------------------------------------------------------------------
# Tier
# ---------------------------------------------------------------------------

def _values(i, kind):
    """A block's (k, v) in one of the dtypes the tier carries: float32,
    a bf16 pool's uint16 bits, and ml_dtypes bf16 (a JAX pool's)."""
    rng = np.random.default_rng(i)
    pair = [rng.standard_normal((2, 4, 2, 4)).astype(np.float32)
            for _ in range(2)]
    if kind == "bits":
        pair = [_bits(torch.from_numpy(x).to(torch.bfloat16)) for x in pair]
    elif kind == "ml_dtypes":
        pair = [np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in pair]
    return tuple(pair)


def _dir(tmp_path, name):
    """A spill directory (the tiers write into it, never create it)."""
    path = tmp_path / name
    path.mkdir()
    return str(path)


def _tier_view(tier, keys):
    return dict(counters=dict(tier.counters), len=len(tier),
                summary=tier.summary_hashes(),
                contains=[tier.contains(k) for k in keys])


@pytest.mark.parametrize("level", ["disk", "store"])
def test_tier_matches_reference(tmp_path, level):
    """put (with overflow host -> store -> dropped and a dedup),
    discard, and pops from either level and of a dropped key: the port's
    tier and the reference's agree on counters, summaries and which keys
    survive, and every pop is bit-exact in each dtype."""
    store = {}
    fns = None
    if level == "store":
        def put(blob):
            store[len(store)] = blob
            return len(store) - 1
        fns = (put, store.__getitem__)
    port = KVTierCache(host_blocks=2, store_blocks=3,
                       spill_dir=_dir(tmp_path, "port"), store=fns)
    ref = jtier.KVTierCache(host_blocks=2, store_blocks=3,
                            spill_dir=_dir(tmp_path, "ref"))
    kinds = ("f32", "bits", "ml_dtypes")
    keys = [(i % 3, (i, i + 1)) for i in range(8)]
    vals = {k: _values(i, kinds[i % 3]) for i, k in enumerate(keys)}
    script = ([("put", k) for k in keys[:6]] + [("put", keys[4])]
              + [("pop", keys[2]), ("discard", keys[3]), ("pop", keys[5]),
                 ("pop", keys[0])]
              + [("put", k) for k in keys[6:]] + [("discard", keys[1])]
              + [("pop", k) for k in keys])
    for op, key in script:
        outs = []
        for tier in (port, ref):
            out = getattr(tier, op)(key, *vals[key]) if op == "put" \
                else getattr(tier, op)(key)
            outs.append(out)
        if op == "pop":
            assert (outs[0] is None) == (outs[1] is None), (op, key)
            if outs[0] is not None:
                for got, want in zip(outs[0], vals[key]):
                    assert got.dtype == want.dtype
                    np.testing.assert_array_equal(got.view(np.uint8),
                                                  want.view(np.uint8))
        assert _tier_view(port, keys) == _tier_view(ref, keys), (op, key)
    assert port.counters["kv_tier_dropped_blocks"] > 0
    assert port.counters["kv_tier_restored_blocks"] > 0
    if level == "store":
        assert store and not list(tmp_path.glob("port/*"))
        # A store outage is a cache miss, never an error.
        port.put(("x",), *vals[keys[0]])
        for k in keys[:3]:
            port.put(k, *vals[k])
        store.clear()
        assert port.pop(("x",)) is None


# ---------------------------------------------------------------------------
# Cache: one script against the reference's
# ---------------------------------------------------------------------------

def _cache_state(cache):
    a = cache.allocator
    k, v = (np.asarray(x) for x in (cache.k, cache.v))
    tier = cache.tier
    return dict(tables=cache.block_tables.tolist(),
                seq_lens=cache.seq_lens.tolist(),
                lanes=[cache.lane_blocks(i) for i in range(cache.max_lanes)],
                free=a.num_free, evictions=a.evictions,
                refs=[a.refcount(b) for b in range(a.num_blocks)],
                evictable=[a.is_evictable(b) for b in range(a.num_blocks)],
                stats=dict(cache.stats), k=k.tobytes(), v=v.tobytes(),
                tier=tier and (dict(tier.counters), len(tier)),
                summary=cache.prefix_summary(256))


def test_cache_script_matches_reference(tmp_path):
    """Seal, spill under pressure, restore on adopt (bit-exact with the
    contents sealed before eviction), an adopt that cannot allocate (its
    tier pops undone), an install that evicts while it allocates (earlier
    installs kept), export and summary: the port's cache and the
    reference's leave the same state and the same pool bytes."""
    rng = np.random.default_rng(0)
    k0 = rng.standard_normal((2, 8, 4, 2, 4)).astype(np.float32)
    v0 = rng.standard_normal((2, 8, 4, 2, 4)).astype(np.float32)
    port = tkv.PagedKVCache(num_blocks=8, device="cpu", **CACHE_KW)
    port.k.copy_(torch.from_numpy(k0))
    port.v.copy_(torch.from_numpy(v0))
    ref = jkv.PagedKVCache(num_blocks=8, **CACHE_KW)
    ref.k, ref.v = jnp.asarray(k0), jnp.asarray(v0)
    port.attach_tier(KVTierCache(3, 2, spill_dir=_dir(tmp_path, "p")))
    ref.attach_tier(jtier.KVTierCache(3, 2, spill_dir=_dir(tmp_path, "r")))
    a, b, c, d = (list(range(s, s + 13)) for s in (1, 100, 200, 300))
    foreign = _port_cache(torch.float32, seed=5)
    _seal(foreign, 0, c)
    shipped = foreign.export_prefix(c)
    snapshot = {}

    def script(cache):
        out = []
        _seal(cache, 0, a)                 # 3 sealed + 1 tail block
        snapshot[id(cache)] = cache.export_prefix(a)
        cache.free_lane(0)
        _seal(cache, 0, b)
        cache.free_lane(0)
        cache.adopt_prefix(1, c + [0] * 8)  # 6 blocks: spills a's and b0
        out.append(cache.match_prefix(a))
        out.append(cache.can_admit_prefix(a))      # spilled: still `need`
        yield out
        cache.free_lane(1)
        out.append(cache.adopt_prefix(2, a))       # restores 3 blocks
        out.append(cache.export_prefix(a))
        yield out
        cache.adopt_prefix(0, d)                   # spills b1, b2
        try:                                       # b needs 4, none free
            cache.adopt_prefix(1, b)
        except RuntimeError as e:
            out.append(str(e))
        yield out
        cache.free_lane(0)
        cache.free_lane(2)
        _seal(cache, 0, b)                         # restores b's 3
        cache.free_lane(0)
        out.append(cache.install_prefix(shipped))  # its 3rd alloc evicts
        out.append(cache.install_prefix(shipped))  # idempotent
        yield out
        _seal(cache, 0, c)
        out.append(cache.lane_blocks(0))
        out.append(cache.export_prefix(c))
        cache.free_lane(0)
        yield out

    for step, (got, want) in enumerate(zip(script(port), script(ref))):
        assert _cache_state(port) == _cache_state(ref), step
        assert repr(got) == repr(want), step
    assert any("exhausted" in str(x) for x in got)
    assert port.stats["restored_blocks"] == 6
    assert port.stats["imported_blocks"] == 3
    assert port.tier.counters["kv_tier_spilled_blocks"] > 6
    np.testing.assert_array_equal(
        port.export_prefix(c)["k"], shipped["k"])
    # a's restored blocks held what was sealed before eviction.
    np.testing.assert_array_equal(got[3]["k"], snapshot[id(port)]["k"])
    np.testing.assert_array_equal(got[3]["v_pool"],
                                  snapshot[id(port)]["v_pool"])


def test_install_keeps_its_blocks_until_every_alloc():
    """Two blocks free, the rest live, and a 3-block chain shipped: an
    install that parked each block evictable as it went would evict its
    own first link for the third.  Both packages install the first two
    links, intact, and stop."""
    foreign = _port_cache(torch.float32, seed=5)
    c = list(range(200, 213))
    _seal(foreign, 0, c)
    shipped = foreign.export_prefix(c)
    got = []
    for cache in (tkv.PagedKVCache(num_blocks=8, device="cpu", **CACHE_KW),
                  jkv.PagedKVCache(num_blocks=8, **CACHE_KW)):
        cache.adopt_prefix(0, list(range(300, 324)))      # 6 blocks live
        got.append((cache.install_prefix(shipped),
                    cache.export_prefix(c), _cache_state(cache)))
    (n, out, state), (ref_n, ref_out, ref_state) = got
    assert n == ref_n == 2 and state == ref_state
    assert out["chain"] == shipped["chain"][:2]
    np.testing.assert_array_equal(out["k"], shipped["k"][:, :2])
    np.testing.assert_array_equal(out["k"], ref_out["k"])


# ---------------------------------------------------------------------------
# Engines on shared weights
# ---------------------------------------------------------------------------

def _engines(tmp_path, **kw):
    """(reference, port) nano engines with a tier of `host` and `store`
    blocks each (files under tmp_path)."""
    host, store = kw.pop("host", 4), kw.pop("store", 8)
    kv_store = kw.pop("kv_store", None)
    ref = jax_engine(**kw)
    ref.cache.attach_tier(jtier.KVTierCache(
        host_blocks=host, store_blocks=store,
        spill_dir=_dir(tmp_path, "r")))
    port = port_engine(kv_tier=True, kv_tier_host_blocks=host,
                       kv_tier_store_blocks=store,
                       spill_dir=_dir(tmp_path, "p"), kv_store=kv_store,
                       **kw)
    return ref, port


def _conserved(cache):
    a = cache.allocator
    live = sum(1 for r in a._ref if r > 0)
    return len(a._free) + len(a._evictable) + live == a.num_blocks


@pytest.mark.parametrize("mode", [{}, dict(temperature=0.8, seed=7)],
                         ids=["greedy", "seeded"])
def test_seal_spill_restore_adopt_matches_reference(tmp_path, mode):
    """The reference's SPILLED lifecycle on both engines: sealed chains
    evicted under pressure come back from the tier and regenerate the
    same tokens as the reference; stats, tier counters and summaries
    agree, and the summary's hashes are the router's chain hashes."""
    ref, port = _engines(tmp_path, num_blocks=8, block_size=16)
    p1 = list(range(1, 49))
    others = [list(range(100, 148)), list(range(200, 248))]
    outs = []
    for eng in (ref, port):
        out = [eng.generate(p, 8, **mode) for p in [p1] + others + [p1]]
        outs.append(out)
    assert outs[1] == outs[0]
    assert outs[1][3] == outs[1][0]
    ref_stats, port_stats = ref.stats(), port.stats()
    assert ref_keys_equal(port_stats, ref_stats)
    assert port_stats["restored_blocks"] > 0
    assert port_stats["kv_tier_spilled_blocks"] > 0
    assert _conserved(port.cache)
    for limit in (4, 256):
        assert port.prefix_summary(limit) == ref.prefix_summary(limit)
    full = port.prefix_summary()
    sealed = {h for p, o in zip([p1] + others, outs[1])
              for h in _chain_hashes(p + o, 16)}
    assert set(full["hashes"]) == sealed
    assert full["tier_blocks"] == len(port.cache.tier) > 0


def test_conservation_under_spill_pressure(tmp_path):
    """free + evictable + live partitions the pool after churn with a
    tier attached, and every step leaves the reference's counters.  The
    port's store level is an injected store (`kv_store`), the
    reference's its spill files."""
    store = {}

    def put(blob):
        store[len(store)] = blob
        return len(store) - 1

    ref, port = _engines(tmp_path, host=1, store=2, num_blocks=6,
                         block_size=16, max_lanes=2,
                         kv_store=(put, store.__getitem__))
    prompts = [list(range(s, s + 33))
               for s in (1, 50, 100, 150, 1, 50, 100, 150)]
    for p in prompts:
        assert port.generate(p, 4) == ref.generate(p, 4)
        assert _conserved(port.cache)
        assert ref_keys_equal(port.stats(), ref.stats())
    a = port.cache.allocator
    assert sum(1 for r in a._ref if r > 0) == 0
    assert len(a._free) + len(a._evictable) == a.num_blocks
    st = port.stats()
    assert st["kv_tier_spilled_blocks"] > 0 and st["restored_blocks"] > 0
    assert store and not list((tmp_path / "p").iterdir())


def test_adopt_pops_the_tier_before_allocating(tmp_path):
    """A 2-block spilled chain in a 2-block tier with no store: adopting
    it evicts (spills) two device blocks, which would push the chain out
    of the tier if it were still there.  Both engines restore it."""
    ref, port = _engines(tmp_path, host=2, store=0, num_blocks=4,
                         block_size=16, max_lanes=1)
    a, b = list(range(1, 34)), list(range(300, 333))
    for eng in (ref, port):
        out_a = eng.generate(a, 4)      # a's 2 sealed blocks
        eng.generate(b, 31)             # 4 blocks: evicts and spills a's
        assert eng.stats()["kv_tier_spilled_blocks"] == 2
        assert eng.generate(a, 4) == out_a
        assert eng.stats()["restored_blocks"] == 2
    assert ref_keys_equal(port.stats(), ref.stats())


def test_bf16_engine_spills_and_restores_bits(tmp_path):
    """A bf16 pool spills its blocks as uint16 bits and restores them bit
    for bit: the restored chain equals its export before eviction."""
    config = dataclasses.replace(gpt.CONFIGS["nano"], dtype=torch.bfloat16)
    eng = InferenceEngine("gpt", config, params=nano_weights()[1],
                          device="cpu", auto_start=False, num_blocks=8,
                          block_size=16, kv_tier=True, kv_tier_host_blocks=1,
                          kv_tier_store_blocks=8, spill_dir=str(tmp_path))
    p1 = list(range(1, 49))
    out = eng.generate(p1, 8)
    before = eng.export_prefix(p1)
    assert before["v"] == 2 and before["k"].dtype == np.uint16
    for s in (100, 200):
        eng.generate(list(range(s, s + 48)), 8)
    assert eng.export_prefix(p1) is None            # spilled, not on device
    assert eng.generate(p1, 8) == out
    after = eng.export_prefix(p1)
    np.testing.assert_array_equal(after["k"], before["k"])
    np.testing.assert_array_equal(after["v_pool"], before["v_pool"])
    assert eng.stats()["restored_blocks"] == len(before["chain"])
