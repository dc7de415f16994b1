"""The port's cached GPT forward (ray_tpu_torch/models/gpt.py) against the
JAX reference on shared weights: chunked prefill, then single-token
decode through the paged cache, logits compared at every step (as
tests/test_inference.py checks the reference against its full forward).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.inference import PagedKVCache as JaxCache
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.inference import PagedKVCache
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.convert import params_from_numpy

# Tiny tensors: one thread each keeps the parallel test workers from
# oversubscribing the host's cores.
torch.set_num_threads(1)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


_jax_forward_cached = jax.jit(jgpt.forward_cached, static_argnames="config")


def _jax_params(config, seed=1):
    return jgpt.init_params(config, jax.random.key(seed))


def test_params_from_numpy_round_trip():
    config = jgpt.CONFIGS["nano"]
    np_params = jax.tree.map(np.asarray, _jax_params(config))
    params = params_from_numpy(np_params, gpt.CONFIGS["nano"], device="cpu")
    flat_np = jax.tree_util.tree_flatten_with_path(np_params)[0]
    for path, arr in flat_np:
        node = params
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.float32 and node.device.type == "cpu"
        np.testing.assert_array_equal(node.numpy(), arr)
    # Shapes are those of the port's own init.
    own = gpt.init_params(gpt.CONFIGS["nano"], device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda t: tuple(t.shape), params)
    # A tree of another config is refused.
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(np_params, dataclasses.replace(
            gpt.CONFIGS["nano"], d_ff=256), device="cpu")


def test_gelu_is_tanh_approximate():
    """Known divergence: jax.nn.gelu defaults to the tanh approximation,
    F.gelu to the exact erf form; the port must use approximate="tanh"."""
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    exact = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


def _run_both(config_j, config_t, tokens, prefill, block_size=8):
    """Run the reference and the port through the same prefill + decode
    schedule on shared weights; returns (jax logits, torch logits) per
    position, as float32 numpy."""
    jparams = _jax_params(config_j)
    tparams = gpt.working_params(
        params_from_numpy(jax.tree.map(np.asarray, jparams), config_t,
                          device="cpu"), config_t, device="cpu")
    n = len(tokens)
    kw = dict(num_blocks=-(-n // block_size) + 1, block_size=block_size,
              max_lanes=1, max_seq_len=config_j.max_seq_len)
    jc = JaxCache.for_model(jgpt, config_j, **kw)
    tc = PagedKVCache.for_model(gpt, config_t, device="cpu", **kw)
    jc.alloc_lane(0, n)
    tc.alloc_lane(0, n)
    got_j, got_t = [], []
    schedule = [(0, prefill)] + [(i, i + 1) for i in range(prefill, n)]
    for start, end in schedule:
        t = end - start
        chunk = np.asarray([tokens[start:end]], np.int32)
        pos = np.asarray([np.arange(start, end)], np.int32)
        x, k, v = _jax_forward_cached(
            jparams, jnp.asarray(chunk), jnp.asarray(pos),
            jnp.ones((1, t), bool), jc.k, jc.v, jc.device_tables(),
            jnp.asarray([end], jnp.int32), config_j)
        jc.update_pools(k, v)
        got_j.append(np.asarray(jgpt.lm_head(jparams, x[:, -1], config_j),
                                np.float32))
        xt, _, _ = gpt.forward_cached(
            tparams, torch.from_numpy(chunk), torch.from_numpy(pos),
            torch.ones(1, t, dtype=torch.bool), tc.k, tc.v,
            tc.device_tables(), torch.tensor([end], dtype=torch.int32),
            config_t)
        got_t.append(gpt.lm_head(tparams, xt[:, -1], config_t).float()
                     .numpy())
    return np.concatenate(got_j), np.concatenate(got_t)


def test_forward_cached_matches_reference_f32():
    config_j, config_t = jgpt.CONFIGS["nano"], gpt.CONFIGS["nano"]
    tokens = np.random.default_rng(1).integers(0, 512, size=21).tolist()
    want, got = _run_both(config_j, config_t, tokens, prefill=6)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    # Same f32 arithmetic on both sides, only the summation order
    # differs (measured 3e-7).  The tighter bound also catches an
    # exact-erf GELU, which moves nano's logits by only 1.4e-4.
    assert np.abs(got - want).max() < 1e-5
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_forward_cached_matches_reference_bf16():
    """nano with bf16 activations and KV pool.  bf16 rounds at different
    places in XLA:CPU and torch (matmul accumulation, GELU, the residual
    adds), so single logits of magnitude ~0.6 may differ by a few bf16
    ulps (2**-8 there); 2e-2 absolute allows five while still catching
    any layout or masking fault (those move logits by O(0.1) or more)."""
    config_j = dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.bfloat16)
    config_t = dataclasses.replace(gpt.CONFIGS["nano"], dtype=torch.bfloat16)
    tokens = np.random.default_rng(2).integers(0, 512, size=19).tolist()
    want, got = _run_both(config_j, config_t, tokens, prefill=8)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_working_params_cast_once_is_bit_identical():
    """The engine's working copy (weights cast to bf16 once) gives the
    same bits as the per-call casts in the forward."""
    config = dataclasses.replace(gpt.CONFIGS["nano"], dtype=torch.bfloat16)
    params = gpt.init_params(config, torch.Generator().manual_seed(3),
                             device="cpu")
    work = gpt.working_params(params, config, device="cpu")
    assert work["blocks"]["wq"].dtype == torch.bfloat16
    assert work["blocks"]["ln1_scale"].dtype == torch.float32
    cache = [PagedKVCache.for_model(gpt, config, num_blocks=4, block_size=8,
                                    max_lanes=2, device="cpu")
             for _ in range(2)]
    tokens = torch.tensor([[5, 9, 1, 3], [7, 2, 8, 0]])
    pos = torch.arange(4).repeat(2, 1)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    outs = []
    for p, c in zip((params, work), cache):
        x, _, _ = gpt.forward_cached(p, tokens, pos,
                                     torch.ones(2, 4, dtype=torch.bool),
                                     c.k, c.v, tables,
                                     torch.tensor([4, 4], dtype=torch.int32),
                                     config)
        outs.append(gpt.lm_head(p, x, config))
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(cache[0].k, cache[1].k)


def test_forward_cached_rejects_moe():
    config = gpt.CONFIGS["nano-moe"]
    params = gpt.init_params(config, device="cpu")
    with pytest.raises(NotImplementedError, match="dense MLP"):
        gpt.forward_cached(params, torch.zeros(1, 1, dtype=torch.long),
                           torch.zeros(1, 1, dtype=torch.long),
                           torch.ones(1, 1, dtype=torch.bool), None, None,
                           None, None, config)
