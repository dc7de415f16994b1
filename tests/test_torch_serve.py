"""The port's serve deployments (ray_tpu_torch/serve/) bound with the
reference's serve plane on one local cluster, on the CPU:

- `LLMDeployment` streams the tokens the port's engine gives directly;
- the reference's `DisaggLLMHandle` over the port's Prefill and Decode
  deployments is token-exact against the monolithic deployment;
- a JAX `PrefillLLMDeployment` handing its frame to the port's
  `DecodeLLMDeployment` through `DisaggLLMHandle` is token-exact against
  the JAX `LLMDeployment`, greedy and seeded (the two packages share gpt
  nano's weights, JAX seed 0)."""

import pytest
import torch

import ray_tpu
from ray_tpu import serve
from ray_tpu.serve.kv_tier import DisaggLLMHandle
from ray_tpu_torch.serve import (DecodeLLMDeployment, LLMDeployment,
                                 PrefillLLMDeployment)
from tests.test_torch_kv_tier import nano_weights, port_engine

torch.set_num_threads(1)

MODES = {"greedy": {}, "seeded": dict(temperature=0.8, seed=11)}
PORT_KW = dict(model="gpt", config="nano", device="cpu", max_lanes=4,
               block_size=16)
TIMEOUT = 120


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu.init(num_cpus=8, object_store_memory=64 << 20)
    serve.start()
    yield info
    serve.shutdown()
    ray_tpu.shutdown()


def _deploy(cls, name, **kw):
    return serve.run(serve.deployment(name=name)(cls).bind(**kw))


@pytest.fixture(scope="module")
def port_handles(cluster):
    """The port's monolithic, prefill and decode deployments, on the
    weights the JAX package draws from seed 0."""
    params = nano_weights()[1]
    return {name: _deploy(cls, f"torch-{name}", params=params, **PORT_KW)
            for name, cls in (("llm", LLMDeployment),
                              ("prefill", PrefillLLMDeployment),
                              ("decode", DecodeLLMDeployment))}


def _prompt(start):
    return list(range(start, start + 40))       # 2 sealed blocks of 16


@pytest.mark.parametrize("mode", MODES)
def test_llm_deployment_streams_the_engines_tokens(port_handles, mode):
    prompt = _prompt(1 if mode == "greedy" else 60)
    handle = port_handles["llm"]
    streamed = list(handle.options("generate", timeout_s=TIMEOUT).stream(
        prompt, max_new_tokens=8, **MODES[mode]))
    want = port_engine(max_lanes=4).generate(prompt, 8, **MODES[mode])
    assert streamed == want
    assert handle.remote(prompt, 8, **MODES[mode]).result(
        timeout=TIMEOUT) == want
    assert handle.stats.remote().result(timeout=TIMEOUT)["active"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_disagg_handle_over_port_deployments(port_handles, mode):
    prompt = _prompt(120 if mode == "greedy" else 180)
    front = DisaggLLMHandle(port_handles["prefill"], port_handles["decode"])
    before = port_handles["decode"].stats.remote().result(timeout=TIMEOUT)
    got = front.generate(prompt, 12, **MODES[mode])
    want = port_handles["llm"].remote(prompt, 12, **MODES[mode]).result(
        timeout=TIMEOUT)
    assert got == want and len(got) == 12
    after = front.stats()["decode"]
    assert after["imported_blocks"] - before["imported_blocks"] == 2


@pytest.fixture(scope="module")
def jax_handles(cluster):
    """The reference's prefill and monolithic deployments (seed 0)."""
    from ray_tpu.serve.kv_tier import PrefillLLMDeployment as JaxPrefill
    from ray_tpu.serve.llm import LLMDeployment as JaxLLM

    jax_kw = dict(model="gpt", config="nano", seed=0, max_lanes=4,
                  block_size=16)
    return {"prefill": serve.run(JaxPrefill.options(
                name="jax-prefill").bind(**jax_kw)),
            "llm": serve.run(JaxLLM.options(name="jax-llm").bind(**jax_kw))}


@pytest.mark.parametrize("mode", MODES)
def test_jax_prefill_to_port_decode(port_handles, jax_handles, mode):
    """The cross-backend gate: the reference's prefill replica ships an f32
    v1 frame; the port's decode replica installs it and streams the JAX
    LLMDeployment's tokens."""
    prompt = _prompt(240 if mode == "greedy" else 300)
    before = port_handles["decode"].stats.remote().result(timeout=TIMEOUT)
    front = DisaggLLMHandle(jax_handles["prefill"], port_handles["decode"],
                            prefill_timeout_s=TIMEOUT)
    got = front.generate(prompt, 12, **MODES[mode])
    want = jax_handles["llm"].remote(prompt, 12, **MODES[mode]).result(
        timeout=TIMEOUT)
    assert got == want and len(got) == 12
    after = port_handles["decode"].stats.remote().result(timeout=TIMEOUT)
    assert after["imported_blocks"] - before["imported_blocks"] == 2
    assert after["prefix_hit_tokens"] - before["prefix_hit_tokens"] == 32
