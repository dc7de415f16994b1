"""Disaggregated serving in the port (ray_tpu_torch: the engine's
prefill / export_prefix / import_prefix, serve/llm.py and
serve/kv_tier/disagg.py) against the JAX reference on shared nano
weights:

- a prefill-only request drains empty, seals its prompt and samples
  nothing;
- export → codec → import is token-exact against a monolithic engine,
  greedy and seeded; a re-import and a foreign shape or dtype install
  nothing;
- across packages: the reference's exported f32 chain installed in the
  port, and the port's in the reference, each decode token-exact
  against the other package's monolithic engine;
- `LLMDeployment.generate` and `DecodeLLMDeployment.generate` resumed
  through `llm_stream_resume` give the unbroken stream;
- the port's Observer sees the events and metrics the reference engine
  records into ray_tpu.util.events / metrics in the same scenario;
- an import made while a step is in flight keeps its bytes in the port
  (the reference drops them), and a lane cancelled while its step is in
  flight keeps its blocks until that step is done, so an import cannot
  be overwritten by it; more client threads than cores importing and
  cancelling against a running scheduler leave exact streams and a
  whole pool."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu.serve import kv_tier as jtier
from ray_tpu.serve import llm as jllm
from ray_tpu.util import events, metrics, tracing
from ray_tpu_torch.inference import InferenceEngine
from ray_tpu_torch.models import gpt
from ray_tpu_torch.serve import (DecodeLLMDeployment, KVBlockCodec,
                                 LLMDeployment, PrefillLLMDeployment,
                                 llm_stream_resume)
from ray_tpu_torch.util.observe import Observer
from tests.test_torch_kv_tier import (_dir, jax_engine, nano_weights,
                                      port_engine, ref_keys_equal)

# Tiny tensors: one thread each keeps the parallel test workers from
# oversubscribing the host's cores.
torch.set_num_threads(1)

MODES = {"greedy": {}, "seeded": dict(temperature=0.8, seed=7)}
PROMPT = list(range(1, 49))             # (48 - 1) // 16 = 2 sealed blocks


def test_prefill_drains_empty():
    ref, port = jax_engine(), port_engine()
    for eng in (ref, port):
        h = eng.prefill(PROMPT, seed=3)
        assert h.tokens(timeout=5) == []
        assert h.finish_reason == "prefill"
        assert h._req.produced == 0 and h._req.emitted == []
        assert eng.stats()["cached_blocks"] == 3     # all 48 written
    assert ref_keys_equal(port.stats(), ref.stats())
    assert port.stats()["decode_steps"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_handoff_token_exact(mode):
    prefill = port_engine()
    prefill.prefill(PROMPT)
    payload = prefill.export_prefix(PROMPT)
    assert payload["v"] == 1 and len(payload["chain"]) == 2
    blob = KVBlockCodec.encode(payload)
    decode = port_engine()
    assert decode.import_prefix(KVBlockCodec.decode(blob)) == 2
    assert decode.import_prefix(KVBlockCodec.decode(blob)) == 0
    got = decode.generate(PROMPT, 12, **MODES[mode])
    assert got == port_engine().generate(PROMPT, 12, **MODES[mode])
    assert got == jax_engine().generate(PROMPT, 12, **MODES[mode])
    st = decode.stats()
    assert st["imported_blocks"] == 2 and st["prefix_hit_tokens"] >= 32
    assert st["prefill_steps"] == 1         # only the 16-token tail


def test_import_refuses_foreign_payloads():
    bf16 = dataclasses.replace(gpt.CONFIGS["nano"], dtype=torch.bfloat16)
    engines = {}
    for name, config in (("f32", "nano"), ("bf16", bf16)):
        eng = InferenceEngine("gpt", config, params=nano_weights()[1],
                              device="cpu", auto_start=False)
        eng.prefill(PROMPT)
        engines[name] = (eng, eng.export_prefix(PROMPT))
    f32, bf16_payload = engines["f32"][1], engines["bf16"][1]
    assert bf16_payload["v"] == 2
    fresh = port_engine()
    rng = np.random.default_rng(0)
    other_shape = {**f32, "k": rng.standard_normal((2, 2, 16, 2, 8)).astype(
        np.float32)}
    other_shape["v_pool"] = other_shape["k"]
    for bad in (bf16_payload, other_shape, {**f32, "block_size": 8},
                {**f32, "k": f32["k"].astype(np.float64)}):
        assert fresh.import_prefix(bad) == 0
    assert engines["bf16"][0].import_prefix(f32) == 0
    assert fresh.stats()["imported_blocks"] == 0
    # The reference refuses the port's bf16 payload too (v2).
    assert jax_engine().import_prefix(bf16_payload) == 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_backend_handoff(direction, mode):
    """One package prefills and exports through its codec; the other
    decodes the frame, installs it and generates — token-exact against
    the exporting package's monolithic engine."""
    if direction == "jax_to_port":
        src, dst, codec_src, codec_dst = (jax_engine, port_engine,
                                          jtier.KVBlockCodec, KVBlockCodec)
    else:
        src, dst, codec_src, codec_dst = (port_engine, jax_engine,
                                          KVBlockCodec, jtier.KVBlockCodec)
    prefill = src()
    prefill.prefill(PROMPT)
    blob = codec_src.encode(prefill.export_prefix(PROMPT))
    decode = dst()
    assert decode.import_prefix(codec_dst.decode(blob)) == 2
    got = decode.generate(PROMPT, 12, **MODES[mode])
    assert got == src().generate(PROMPT, 12, **MODES[mode])
    assert decode.stats()["prefix_hit_tokens"] == 32


def test_llm_stream_resume_is_the_reference_policy():
    cases = [(([1, 2], 8), {}, [5, 6, 7]),
             (([1], 4, 0.9, 99, 7), {}, [3]),
             (([1], 3), {}, [4, 5, 6]),
             (([1], 9), {"eos_id": 6}, [4, 6]),
             ((), {"prompt": [4, 4], "max_new_tokens": 5, "seed": 2,
                   "kv_handoff": b"x"}, [1, 2])]
    for args, kwargs, received in cases:
        assert llm_stream_resume(args, kwargs, received) == \
            jllm.llm_stream_resume(args, kwargs, received)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cls", ["LLMDeployment", "DecodeLLMDeployment"])
def test_generate_resumed_through_llm_stream_resume(cls, mode):
    """A stream cut after 5 tokens and resubmitted through the failover
    policy (to a fresh replica) continues the unbroken stream."""
    kw = dict(device="cpu", params=nano_weights()[1], max_lanes=2)
    kwargs = dict(MODES[mode])
    if cls == "DecodeLLMDeployment":
        frame = PrefillLLMDeployment("gpt", "nano", **kw).prefill(PROMPT)
        kwargs["kv_handoff"] = frame
        make = lambda: DecodeLLMDeployment("gpt", "nano", **kw)  # noqa: E731
    else:
        make = lambda: LLMDeployment("gpt", "nano", **kw)  # noqa: E731
    full = list(make().generate(PROMPT, 16, **kwargs))
    assert len(full) == 16
    stream = make().generate(PROMPT, 16, **kwargs)
    received = [next(stream) for _ in range(5)]
    stream.close()                      # the replica died mid-stream
    args, kwargs2 = llm_stream_resume((PROMPT, 16), kwargs, received)
    rest = list(make().generate(*args, **kwargs2))
    assert received + rest == full
    replica = make()
    assert replica(PROMPT, 16, **kwargs) == full
    assert replica.stats()["active"] == 0


def test_llm_deployment_takes_the_reference_config_defaults():
    """The knobs the reference reads from GLOBAL_CONFIG: spec_k 4 when
    `speculative`, spec_adaptive on, a prefix summary bounded by
    `prefix_summary_size` (256 by default)."""
    from ray_tpu._private.config import GLOBAL_CONFIG

    kw = dict(device="cpu", params=nano_weights()[1], max_lanes=2)
    spec = LLMDeployment("gpt", "nano", speculative=True, **kw)
    assert spec.stats()["spec_k"] == GLOBAL_CONFIG.spec_k == 4
    assert spec._engine._spec_adaptive is GLOBAL_CONFIG.spec_adaptive
    assert LLMDeployment("gpt", "nano", **kw).stats()["spec_k"] == 0
    small = LLMDeployment("gpt", "nano", prefix_summary_size=1, **kw)
    small(PROMPT, 2)
    summary = small.prefix_summary()
    assert len(summary["hashes"]) == 1 and summary["indexed_blocks"] == 3
    assert GLOBAL_CONFIG.serve_prefix_summary_size == 256


class Recorder(Observer):
    """Records events as (plane, kind, phase, fields) and metrics as the
    reference's registry would hold them (counter sums, the last gauge
    value, the number of histogram samples)."""

    def __init__(self, trace=None):
        self.events, self.metrics, self.trace = [], {}, trace

    def context(self):
        return self.trace

    def record(self, plane, kind, trace=None, **fields):
        self.events.append((plane, kind, None, fields))

    def begin(self, plane, kind, ctx=None, **fields):
        self.events.append((plane, kind, "B", fields))
        return (plane, kind)

    def end(self, token, **fields):
        if token is not None:
            self.events.append((*token, "E", fields))

    def inc(self, name, n=1.0):
        self.metrics[name] = self.metrics.get(name, 0.0) + n

    def set(self, name, value):
        self.metrics[name] = float(value)

    def observe(self, name, value):
        self.metrics[name] = self.metrics.get(name, 0.0) + 1


METRICS = ("inference_prefix_hit_tokens", "inference_prefix_miss_tokens",
           "inference_prefix_hits", "inference_prefix_misses",
           "inference_kv_blocks_evicted", "inference_waiting_requests",
           "inference_ttft_s", "inference_tbt_s", "kv_tier_spilled_blocks",
           "kv_tier_restored_blocks", "kv_tier_dropped_blocks")


def _metric_values():
    out = {}
    for name in METRICS:
        v = metrics.read(name)
        out[name] = v["count"] if isinstance(v, dict) else (v or 0.0)
    return out


def _scenario(eng, params):
    """Admissions with hits and misses, a prefill-only request, export
    and import, a cancel mid-flight, a deadline, a weight swap, and
    spill / restore through a small pool."""
    eng.generate(PROMPT, 6)
    eng.prefill(PROMPT[:40] + [7] * 8)
    eng.import_prefix(eng.export_prefix(PROMPT))
    h = eng.submit(list(range(60, 90)), 8)
    eng.submit([5, 6, 7], 4, deadline_s=0.0)
    eng.step()
    h.cancel()
    eng.update_params(params)
    for s in (100, 200):
        eng.generate(list(range(s, s + 48)), 6)
    eng.generate(PROMPT, 6, temperature=0.8, seed=1)
    while eng.step():
        pass


@pytest.mark.parametrize("traced", [False, True],
                         ids=["untraced", "traced"])
def test_observer_matches_reference_events_and_metrics(tmp_path, traced):
    """The same scenario on both engines: the port's Observer receives
    the reference's event sequence (plane, kind, span phase, fields) and
    metric values.  Traced requests (a trace context at submit) add the
    per-request prefill and decode spans."""
    kw = dict(num_blocks=8, block_size=16, max_lanes=2)
    ref = jax_engine(**kw)
    ref.cache.attach_tier(jtier.KVTierCache(
        host_blocks=4, store_blocks=8, spill_dir=_dir(tmp_path, "r")))
    rec = Recorder(trace=("t", "s") if traced else None)
    port = port_engine(kv_tier=True, kv_tier_host_blocks=4,
                       kv_tier_store_blocks=8, spill_dir=_dir(tmp_path, "p"),
                       observer=rec, **kw)
    events.reset()
    before = _metric_values()
    with tracing.trace("disagg") if traced else contextlib.nullcontext():
        _scenario(ref, nano_weights()[0])
    after = _metric_values()
    got_ref = []
    for e in events.snapshot():
        if e["plane"] not in ("engine", "kv"):
            continue
        fields = dict(e["payload"] or {})
        phase = fields.pop("ph", None)
        fields.pop("dur", None)
        fields.pop("parent", None)          # the trace's span id
        got_ref.append((e["plane"], e["kind"], phase, fields))
    _scenario(port, nano_weights()[1])
    assert rec.events == got_ref
    kinds = {(p, k) for p, k, _, _ in got_ref}
    assert (("engine", "decode") in kinds) == traced
    for pair in [("engine", "submit"), ("engine", "step"),
                 ("engine", "finish"), ("engine", "prefix_hit"),
                 ("engine", "prefix_miss"), ("engine", "lane_evict"),
                 ("engine", "deadline_kill"), ("engine", "weights_swap"),
                 ("engine", "blocks_evicted"), ("kv", "export"),
                 ("kv", "import"), ("kv", "spilled"), ("kv", "restored")]:
        assert pair in kinds, pair
    for name in METRICS:
        want = after[name] - before[name] \
            if name != "inference_waiting_requests" else after[name]
        assert rec.metrics.get(name, 0.0) == want, name
    assert ref_keys_equal(port.stats(), ref.stats())


def test_lane_cancelled_mid_step_frees_after_the_step():
    """A request is cancelled, and a chain imported, while its decode
    step is in flight (as another thread would, outside the engine
    lock).  The lane's blocks are freed only when the step commits, so
    the import cannot be handed the block that step is still writing:
    the imported chain keeps the shipped bytes."""
    src = port_engine()
    src.prefill(PROMPT)
    payload = src.export_prefix(PROMPT)
    eng = port_engine()
    h = eng.submit(list(range(300, 330)), 20)
    while not eng.stats()["decode_steps"]:
        eng.step()
    lane_blocks = eng.cache.lane_blocks(0)
    run = eng._run_step

    def in_flight(*args, **kw):
        h.cancel()
        assert eng.import_prefix(payload) == 2
        return run(*args, **kw)

    eng._run_step = in_flight
    eng.step()
    eng._run_step = run
    got = eng.export_prefix(PROMPT)
    installed = [eng.cache._index[k] for k in list(eng.cache._index)[-2:]]
    assert not set(installed) & set(lane_blocks)
    for key in ("k", "v_pool"):
        np.testing.assert_array_equal(got[key], payload[key])
    assert h.finish_reason == "cancelled"
    assert eng.stats()["active"] == 0
    assert eng.cache.allocator.num_free == eng.cache.allocator.num_blocks
    assert eng.generate(PROMPT, 8) == jax_engine().generate(PROMPT, 8)


def test_an_import_during_a_step_survives_unlike_the_reference():
    """A divergence from the reference: an import made while a step is
    in flight (another thread, outside the engine lock).  The port
    writes its pools in place and keeps the imported bytes; the
    reference rebinds the step's output pools afterwards
    (`update_pools`), which drops the install while its chain stays
    indexed."""
    src = port_engine()
    src.prefill(PROMPT)
    payload = src.export_prefix(PROMPT)
    kept = {}
    for name, eng, hook in (("port", port_engine(), "_run_step"),
                            ("reference", jax_engine(), "update_pools")):
        target = eng if name == "port" else eng.cache
        eng.submit(list(range(300, 330)), 20)
        eng.step()
        eng.step()
        original = getattr(target, hook)

        def in_flight(*args, _eng=eng, _original=original, **kw):
            assert _eng.import_prefix(payload) == 2
            return _original(*args, **kw)

        setattr(target, hook, in_flight)
        eng.step()
        setattr(target, hook, original)
        got = eng.export_prefix(PROMPT)
        assert got["chain"] == payload["chain"]
        kept[name] = np.array_equal(got["k"], payload["k"])
    assert kept == {"port": True, "reference": False}


def test_concurrent_imports_and_cancels_against_a_running_scheduler():
    """More client threads than cores against one auto-started engine,
    with a short switch interval: each imports its chain, some also
    submit and cancel a throwaway request mid-flight, then generate.
    Every stream equals a monolithic engine's and the pool comes back
    whole (free + evictable == all blocks)."""
    import sys
    import threading

    prompts = [list(range(s, s + 40)) for s in range(1, 400, 25)]
    src = port_engine()
    payloads = []
    for p in prompts:
        src.prefill(p)
        payloads.append(src.export_prefix(p))
    want = [port_engine().generate(p, 6) for p in prompts]
    eng = InferenceEngine("gpt", "nano", params=nano_weights()[1],
                          device="cpu", max_lanes=4)
    got = [None] * len(prompts)

    def client(i):
        eng.import_prefix(payloads[i])
        if i % 3 == 0:
            throwaway = eng.submit(prompts[i][::-1], 8)
            next(iter(throwaway))
            throwaway.cancel()
        got[i] = eng.submit(prompts[i], 6).tokens(timeout=60)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        eng.shutdown()
    assert got == want
    a = eng.cache.allocator
    assert sum(1 for r in a._ref if r > 0) == 0
    assert len(a._free) + len(a._evictable) == a.num_blocks
