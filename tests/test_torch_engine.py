"""The slice as a whole: the port's InferenceEngine against the JAX
reference engine on shared nano weights, token for token — mixed prompt
lengths with lanes admitted mid-flight, prefix-cache hits, greedy and
seeded sampling, eos and max_new_tokens stops — plus the port's own
lane lifecycle (cancel, deadline, auto-start) and its device rule."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.inference import InferenceEngine as JaxEngine
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.inference import InferenceEngine, PagedKVCache
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.convert import params_from_numpy

# Tiny tensors: one thread each keeps the parallel test workers from
# oversubscribing the host's cores.
torch.set_num_threads(1)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

ENGINE_KW = dict(max_lanes=2, block_size=8, prefill_chunk=4,
                 auto_start=False)


@pytest.fixture(scope="module")
def engines():
    """A factory of (reference, port) engine pairs on the same weights."""
    jparams = jgpt.init_params(jgpt.CONFIGS["nano"], jax.random.key(7))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                gpt.CONFIGS["nano"], device="cpu")

    def make(**kw):
        kw = {**ENGINE_KW, **kw}
        return (JaxEngine("gpt", "nano", params=jparams, **kw),
                InferenceEngine("gpt", "nano", params=tparams, device="cpu",
                                **kw))
    return make


def _drive(engine, schedule):
    """Submit each (step_index, prompt, kwargs) when the scheduler
    reaches that step; run to idle.  Returns [(tokens, finish_reason)]
    in schedule order, plus the engine's stats."""
    handles = {}
    pending = sorted(enumerate(schedule), key=lambda e: e[1][0])
    step = 0
    while True:
        while pending and pending[0][1][0] <= step:
            i, (_, prompt, kw) = pending.pop(0)
            handles[i] = engine.submit(prompt, **kw)
        busy = engine.step()
        step += 1
        if not busy and not pending:
            break
    out = [(handles[i].tokens(timeout=5), handles[i].finish_reason)
           for i in range(len(schedule))]
    return out, engine.stats()


def _prompt(rng, n):
    return rng.integers(0, 512, size=n).tolist()


def test_engine_mixed_lengths_mid_flight_greedy_and_seeded(engines):
    rng = np.random.default_rng(0)
    schedule = [
        (0, _prompt(rng, 3), dict(max_new_tokens=5)),
        (0, _prompt(rng, 11), dict(max_new_tokens=9, temperature=0.9,
                                   seed=11)),
        (0, _prompt(rng, 6), dict(max_new_tokens=4)),      # waits a lane
        (3, _prompt(rng, 17), dict(max_new_tokens=6, temperature=1.3,
                                   seed=2**32 - 3)),
        (5, _prompt(rng, 1), dict(max_new_tokens=7, temperature=0.6)),
    ]
    ref, jstats = _drive(engines()[0], schedule)
    got, tstats = _drive(engines()[1], schedule)
    assert got == ref
    assert all(reason == "length" for _, reason in got)
    assert [len(t) for t, _ in got] == [5, 9, 4, 6, 7]
    assert tstats["decode_steps"] > 0 and tstats["prefill_steps"] > 0
    assert tstats["active"] == 0 and tstats["free_blocks"] == \
        jstats["free_blocks"]


def test_engine_prefix_cache_hits_token_exact(engines):
    rng = np.random.default_rng(1)
    shared = _prompt(rng, 20)                  # two full 8-token blocks
    schedule = [
        (0, shared + _prompt(rng, 3), dict(max_new_tokens=6)),
        # After the first request sealed the shared blocks:
        (12, shared + _prompt(rng, 5), dict(max_new_tokens=6)),
        (12, shared + _prompt(rng, 2), dict(max_new_tokens=5,
                                            temperature=0.8, seed=5)),
    ]
    ref, jstats = _drive(engines()[0], schedule)
    got, tstats = _drive(engines()[1], schedule)
    assert got == ref
    assert tstats["prefix_hits"] == jstats["prefix_hits"] >= 2
    assert tstats["prefix_hit_tokens"] == jstats["prefix_hit_tokens"] >= 32
    # With the cache off the port produces the same tokens cold.
    cold, cstats = _drive(engines(prefix_cache=False)[1], schedule)
    assert cold == got and cstats["prefix_hits"] == 0


def test_engine_eos_and_length_stops(engines):
    rng = np.random.default_rng(2)
    prompt = _prompt(rng, 9)
    free, _ = _drive(engines()[1], [(0, prompt, dict(max_new_tokens=8))])
    eos = free[0][0][3]                        # the 4th greedy token
    schedule = [(0, prompt, dict(max_new_tokens=8, eos_id=eos)),
                (0, _prompt(rng, 4), dict(max_new_tokens=2, eos_id=511))]
    ref, _ = _drive(engines()[0], schedule)
    got, _ = _drive(engines()[1], schedule)
    assert got == ref
    toks, reason = got[0]
    assert reason == "eos" and toks[-1] == eos
    assert len(toks) == free[0][0].index(eos) + 1
    assert got[1][1] in ("length", "eos")


def test_engine_cancel_and_deadline_free_the_lane():
    eng = InferenceEngine("gpt", "nano", device="cpu", **ENGINE_KW)
    total = eng.cache.allocator.num_free
    h1 = eng.submit([1, 2, 3], max_new_tokens=50)
    h2 = eng.submit([4, 5, 6], max_new_tokens=50, deadline_s=0.0)
    h3 = eng.submit([7, 8], max_new_tokens=50)         # queued behind
    eng.step()
    assert h2.finish_reason == "deadline" and h2.tokens(timeout=1) == []
    assert eng.num_active == 2                          # h1 + h3 admitted
    assert h1.cancel() and h1.finish_reason == "cancelled"
    assert not h1.cancel()                              # idempotent
    assert h3.cancel() and eng.num_active == 0
    assert eng.cache.allocator.num_free == total
    assert not eng.step()


def test_engine_auto_start_streams_and_shuts_down():
    eng = InferenceEngine("gpt", "nano", device="cpu", max_lanes=2,
                          block_size=8, prefill_chunk=4)
    handles = [eng.submit([3, 1, 4, 1, 5][:n], max_new_tokens=4)
               for n in (1, 3, 5)]
    streamed = [list(h) for h in handles]
    assert all(len(s) == 4 for s in streamed)
    assert all(h.finish_reason == "length" for h in handles)
    eng.shutdown()
    assert eng._thread is None or not eng._thread.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit([1])


def test_unported_options_raise(tmp_path):
    """No engine option raises any more: the KV spill tier, the last to
    be ported, builds and spills.  Two 48-token prompts through a 4-block
    pool evict the first one's sealed blocks into the tier's host level,
    and its tier's overflow reaches the files under spill_dir."""
    eng = InferenceEngine("gpt", "nano", device="cpu", kv_tier=True,
                          num_blocks=4, block_size=16, max_lanes=1,
                          kv_tier_host_blocks=1, spill_dir=str(tmp_path),
                          auto_start=False)
    eng.generate(list(range(1, 49)), 4)
    eng.generate(list(range(100, 148)), 4)
    st = eng.stats()
    assert st["kv_tier_spilled_blocks"] >= 2 and st["blocks_evicted"] >= 2
    assert list(tmp_path.iterdir())


@pytest.mark.parametrize("kw", [dict(spec_k=2), dict(capture_logp=True)],
                         ids=["spec_k", "capture_logp"])
def test_spec_and_logp_options_run_a_step(kw):
    """Speculative decoding and log-prob capture are ported: an engine
    with either builds and runs steps."""
    eng = InferenceEngine("gpt", "nano", device="cpu", **ENGINE_KW, **kw)
    h = eng.submit([1, 2, 1, 2, 1], max_new_tokens=3)
    assert eng.step()
    while eng.step():
        pass
    assert len(h.tokens(timeout=5)) == 3
    assert len(h.logps) == (3 if kw.get("capture_logp") else 0)


def test_device_rule_raises_without_cuda():
    """device=None means CUDA: with no card every entry point raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine("gpt", "nano")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt.init_params(gpt.CONFIGS["nano"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(1, 1, 64, num_blocks=2, block_size=4, max_lanes=1,
                     max_seq_len=8)
