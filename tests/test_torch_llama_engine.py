"""The slice as a whole for Llama: the port's InferenceEngine serving the
Llama family against the JAX reference engine on shared weights, token
for token (lanes admitted mid-flight, a prefix-cache hit, greedy and
seeded sampling), at head_dim 64 with q_per_kv 2 and at llama-tiny
(head_dim 16, whose decode step takes the masked-dense route); plus the
device rule of the Llama entry points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference import InferenceEngine as JaxEngine
from ray_tpu.models import llama as jllama
from ray_tpu_torch.inference import InferenceEngine
from ray_tpu_torch.models import llama
from ray_tpu_torch.models._functional import adamw
from ray_tpu_torch.models.convert import params_from_numpy

# Tiny tensors: one thread each keeps the parallel test workers from
# oversubscribing the host's cores.
torch.set_num_threads(1)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

ENGINE_KW = dict(max_lanes=2, block_size=8, prefill_chunk=4,
                 auto_start=False)
HEAD_DIM_64 = dict(vocab_size=512, n_layers=2, d_model=256, n_heads=4,
                   n_kv_heads=2, d_ff=512, max_seq_len=128)


def _configs(name):
    if name == "llama-tiny":
        return jllama.CONFIGS[name], llama.CONFIGS[name]
    return (jllama.LlamaConfig(dtype=jnp.float32, **HEAD_DIM_64),
            llama.LlamaConfig(dtype=torch.float32, **HEAD_DIM_64))


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


@pytest.mark.parametrize("name", ["head_dim-64", "llama-tiny"])
def test_engine_token_exact_with_reference(name):
    """Three requests on two lanes: the third waits for a lane and is
    admitted mid-flight onto the first one's sealed 16-token prefix;
    one greedy, two seeded."""
    config_j, config_t = _configs(name)
    jparams = jllama.init_params(config_j, jax.random.key(7))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                config_t, device="cpu")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 512, 18).tolist()
    schedule = [
        (0, shared + [5], dict(max_new_tokens=6)),
        (0, rng.integers(0, 512, 11).tolist(),
         dict(max_new_tokens=9, temperature=0.9, seed=11)),
        (2, shared + [9, 4], dict(max_new_tokens=5, temperature=1.3,
                                  seed=2**32 - 3)),
    ]
    ref, jstats = _drive(JaxEngine("llama", config_j, params=jparams,
                                   **ENGINE_KW), schedule)
    got, tstats = _drive(InferenceEngine("llama", config_t, params=tparams,
                                         device="cpu", **ENGINE_KW),
                         schedule)
    assert got == ref
    assert [len(t) for t, _ in got] == [6, 9, 5]
    assert tstats["prefix_hits"] == jstats["prefix_hits"] >= 1
    assert tstats["prefix_hit_tokens"] == jstats["prefix_hit_tokens"] >= 16
    assert tstats["decode_steps"] > 0 and tstats["active"] == 0
    # The cache holds the kv heads un-repeated.
    eng = InferenceEngine("llama", config_t, params=tparams, device="cpu",
                          **ENGINE_KW)
    assert eng.cache.k.shape[-2:] == (config_t.n_kv_heads,
                                      config_t.head_dim)


def test_device_rule_raises_without_cuda():
    """device=None means CUDA: with no card every Llama entry point
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None is valid")
    tiny = llama.CONFIGS["llama-tiny"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine("llama", "llama-tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.init_params(tiny)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.make_train_step(tiny, adamw(1e-4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.working_params(llama.init_params(tiny, device="cpu"), tiny)


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="'gpt', 'llama' and 'mellum'"):
        InferenceEngine("mamba", "tiny", device="cpu")
