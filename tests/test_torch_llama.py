"""The port's Llama family (ray_tpu_torch/models/llama.py) against the JAX
reference on shared weights: RoPE, RMSNorm, the GQA block, the forward
logits, the loss and every gradient, three AdamW steps against
optax.adamw, and the cached forward through the paged cache.

The main config has head_dim 64 (vocab 512, 2 layers, d_model 256, 4
query heads over 2 kv heads, d_ff 512, L 128), so that the reference
really runs its Pallas flash kernels (interpreted on the CPU) and
q_per_kv is 2; llama-tiny (head_dim 16) takes both packages' reference
routes."""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.inference import PagedKVCache as JaxCache
from ray_tpu.models import llama as jllama
from ray_tpu_torch.inference import PagedKVCache
from ray_tpu_torch.models import llama
from ray_tpu_torch.models._functional import adamw
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy

# Tiny tensors: one thread each keeps the parallel test workers from
# oversubscribing the host's cores.
torch.set_num_threads(1)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

SIZES = dict(vocab_size=512, n_layers=2, d_model=256, n_heads=4,
             n_kv_heads=2, d_ff=512, max_seq_len=128)
CFG_J = jllama.LlamaConfig(dtype=jnp.float32, **SIZES)
CFG_T = llama.LlamaConfig(dtype=torch.float32, **SIZES)
LR = 1e-4


@functools.cache
def _np_params(config_j=CFG_J, seed=0):
    return jax.tree.map(np.asarray, jllama.init_params(config_j,
                                                       jax.random.key(seed)))


def _tokens(seed, b=2, l=128):
    return np.random.default_rng(seed).integers(0, 512, (b, l)).astype(
        np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _rel_err(got, want):
    """max |got - want| / max |want| of one leaf."""
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / \
        max(np.abs(want).max(), 1e-30)


def _port_loss_and_grads(np_params, batch, config=CFG_T):
    params = llama._map(params_from_numpy(np_params, config, device="cpu"),
                        lambda t: t.requires_grad_())
    loss = llama.loss_fn(params, batch, config)
    leaves = _flat(params)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: g.numpy()
                                  for k, g in zip(leaves, grads)}


@pytest.mark.parametrize("name", list(jllama.CONFIGS))
def test_num_params_and_configs_match_reference(name):
    want, got = jllama.CONFIGS[name], llama.CONFIGS[name]
    assert llama.num_params(got) == jllama.num_params(want)
    for field in ("vocab_size", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "max_seq_len", "rope_theta",
                  "norm_eps", "remat"):
        assert getattr(got, field) == getattr(want, field), field
    assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
    assert llama.num_params(llama.CONFIGS["llama-1b"]) == 1_100_048_384


@pytest.mark.parametrize("theta", [1e4, 5e5])
@pytest.mark.parametrize("offset", [0, 7, "per-lane"])
def test_rope_matches_reference(theta, offset):
    """Scalar and per-lane [B] offsets, positions up to 2047.  The f32
    frequencies differ by ~2e-10 and sin/cos by ~6e-8 between the two
    libraries; atol 1e-5 leaves room for that while a wrong pairing,
    frequency or offset moves entries by O(1)."""
    x = np.random.default_rng(1).standard_normal((3, 16, 2, 64)).astype(
        np.float32)
    off = np.asarray([0, 777, 2032], np.int32) if offset == "per-lane" \
        else offset
    want = jllama._rope(jnp.asarray(x), theta, jnp.asarray(off))
    got = llama._rope(torch.from_numpy(x), theta,
                      torch.from_numpy(off) if offset == "per-lane" else off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 5, 256)) * 3).astype(np.float32)
    scale = rng.standard_normal(256).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jllama._rmsnorm(xj, jnp.asarray(scale), 1e-5)
                      .astype(jnp.float32))
    got = llama._rmsnorm(xt, torch.from_numpy(scale), 1e-5)
    assert got.dtype == xt.dtype
    # f32: the same arithmetic; bf16: one rounding of the same f32 value,
    # which may land one bf16 ulp (2**-8 relative) apart.
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else \
        dict(atol=0, rtol=2 ** -8)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def _block_pair(position_offset=3):
    """One layer of the reference's weights, a random x, and both
    packages' _block outputs on them."""
    layer = {k: v[1] for k, v in _np_params()["blocks"].items()}
    x = np.random.default_rng(3).standard_normal((2, 128, 256)).astype(
        np.float32)
    want = jllama._block(jnp.asarray(x), jax.tree.map(jnp.asarray, layer),
                         CFG_J, None, position_offset)
    p = {k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
    return (np.asarray(want),
            lambda: llama._block(torch.from_numpy(x), p, CFG_T,
                                 position_offset).numpy())


def test_block_gqa_matches_reference(monkeypatch):
    """q_per_kv 2 over two kv heads that differ: query head h reads kv
    head h // 2 (`jnp.repeat` is interleaved).  The same block with the
    kv heads tiled instead (`repeat`) must disagree."""
    layer = _np_params()["blocks"]
    assert np.abs(layer["wk"][:, :, 0] - layer["wk"][:, :, 1]).max() > 0.1
    want, run = _block_pair()
    np.testing.assert_allclose(run(), want, atol=1e-4, rtol=1e-4)
    monkeypatch.setattr(llama, "_repeat_kv",
                        lambda x, n: x.repeat(1, 1, n, 1))
    assert np.abs(run() - want).max() > 1e-2


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_every_gradient_match_reference(masked):
    """f32: the port's plain flash (over the repeated kv heads) and CE
    against the reference's Pallas flash (interpreted) and CE.  Per
    leaf, max |dg| / max |g| <= 1e-4: the same f32 arithmetic summed in
    other orders, while a wrong mask, pairing or missing term moves a
    gradient by O(1)."""
    tokens = _tokens(1)
    batch_j = {"tokens": jnp.asarray(tokens)}
    batch_t = {"tokens": torch.from_numpy(tokens)}
    if masked:
        mask = (np.random.default_rng(2).random(tokens.shape) > 0.3).astype(
            np.float32)
        batch_j["loss_mask"] = jnp.asarray(mask)
        batch_t["loss_mask"] = torch.from_numpy(mask)
    np_params = _np_params()
    want_loss, want_grads = jax.value_and_grad(jllama.loss_fn)(
        jax.tree.map(jnp.asarray, np_params), batch_j, CFG_J)
    loss, grads = _port_loss_and_grads(np_params, batch_t)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, want_grads))
    assert set(grads) == set(want)
    for k in want:
        assert _rel_err(grads[k], want[k]) <= 1e-4, k


def test_loss_matches_reference_bf16():
    """bf16 activations: bf16 rounds at other places in XLA:CPU and
    torch, so the loss agrees to 1e-3 relative."""
    cfg_j = dataclasses.replace(CFG_J, dtype=jnp.bfloat16)
    cfg_t = dataclasses.replace(CFG_T, dtype=torch.bfloat16)
    tokens = _tokens(3)
    want = jllama.loss_fn(jax.tree.map(jnp.asarray, _np_params()),
                          {"tokens": jnp.asarray(tokens)}, cfg_j)
    got = llama.loss_fn(params_from_numpy(_np_params(), cfg_t, device="cpu"),
                        {"tokens": torch.from_numpy(tokens)}, cfg_t)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-3)


def test_three_adamw_steps_match_optax():
    """Three steps of make_train_step with adamw(1e-4) against the
    reference's with optax.adamw(1e-4), from the same weights on the
    same batches, at test_torch_gpt_train.py's tolerance: 2 * lr per
    step, since Adam's first steps move a weight by about lr * sign(g)."""
    init_j, step_j = jllama.make_train_step(CFG_J, optax.adamw(LR))
    state_j = init_j(jax.random.key(0))
    step_j = jax.jit(step_j)
    init_t, step_t = llama.make_train_step(CFG_T, adamw(LR), device="cpu")
    state_t = init_t(params=params_from_numpy(
        jax.tree.map(np.asarray, state_j["params"]), CFG_T, device="cpu"))
    for i in range(3):
        tokens = _tokens(10 + i)
        state_j, m_j = step_j(state_j, {"tokens": jnp.asarray(tokens)})
        state_t, m_t = step_t(state_t, {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=1e-5)
    assert state_t["step"] == 3 and int(state_j["step"]) == 3
    got = _flat(params_to_numpy(state_t["params"]))
    want = _flat(jax.tree.map(np.asarray, state_j["params"]))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2 * LR * 3,
                                   rtol=0, err_msg=k)


def test_remat_gives_the_same_gradients():
    tokens = torch.from_numpy(_tokens(5))
    _, plain = _port_loss_and_grads(_np_params(), {"tokens": tokens})
    _, remat = _port_loss_and_grads(
        _np_params(), {"tokens": tokens},
        dataclasses.replace(CFG_T, remat=True))
    for k in plain:
        np.testing.assert_array_equal(remat[k], plain[k], err_msg=k)


def test_forward_logits_match_reference():
    tokens = _tokens(6, l=64)
    want = jllama.forward(jax.tree.map(jnp.asarray, _np_params()),
                          jnp.asarray(tokens), CFG_J, position_offset=32)
    got = llama.forward(params_from_numpy(_np_params(), CFG_T, device="cpu"),
                        torch.from_numpy(tokens), CFG_T, position_offset=32)
    assert tuple(got.shape) == (2, 64, 512)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def _grad_nodes(t):
    """The names of every autograd node that `t` depends on."""
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(fn.name())
        todo.extend(f for f, _ in fn.next_functions)
    return names


def test_flash_kernel_path_is_taken():
    """head_dim 64, square causal: the blocks' attention is the autograd
    Function over K1-K3, not the reference fallback; at llama-tiny's
    head_dim 16 it is the fallback, as in the reference."""
    params = llama._map(params_from_numpy(_np_params(), CFG_T, device="cpu"),
                        lambda t: t.requires_grad_())
    loss = llama.loss_fn(params, {"tokens": torch.from_numpy(_tokens(7))},
                         CFG_T)
    assert "_FlashAttentionBackward" in _grad_nodes(loss)
    tiny = llama.CONFIGS["llama-tiny"]
    params = llama._map(llama.init_params(tiny, device="cpu"),
                        lambda t: t.requires_grad_())
    loss = llama.loss_fn(params, {"tokens": torch.zeros(1, 8,
                                                        dtype=torch.long)},
                         tiny)
    assert "_FlashAttentionBackward" not in _grad_nodes(loss)


_jax_forward_cached = jax.jit(jllama.forward_cached,
                              static_argnames="config")


def _cached_pair(config_j, config_t, tokens, prefill, block_size=8):
    """The reference and the port through the same prefill + decode
    schedule on shared weights; (jax logits, torch logits) per position
    as float32 numpy."""
    jparams = jax.tree.map(jnp.asarray, _np_params(
        dataclasses.replace(config_j, dtype=jnp.float32), 1))
    tparams = llama.working_params(
        params_from_numpy(jax.tree.map(np.asarray, jparams), config_t,
                          device="cpu"), config_t, device="cpu")
    n = len(tokens)
    kw = dict(num_blocks=-(-n // block_size) + 1, block_size=block_size,
              max_lanes=1, max_seq_len=config_j.max_seq_len)
    jc = JaxCache.for_model(jllama, config_j, **kw)
    tc = PagedKVCache.for_model(llama, config_t, device="cpu", **kw)
    assert tuple(tc.k.shape[-2:]) == (config_t.n_kv_heads,
                                      config_t.head_dim)
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
        got_j.append(np.asarray(jllama.lm_head(jparams, x[:, -1], config_j),
                                np.float32))
        xt, _, _ = llama.forward_cached(
            tparams, torch.from_numpy(chunk), torch.from_numpy(pos),
            torch.ones(1, t, dtype=torch.bool), tc.k, tc.v,
            tc.device_tables(), torch.tensor([end], dtype=torch.int32),
            config_t)
        got_t.append(llama.lm_head(tparams, xt[:, -1], config_t).float()
                     .numpy())
    return np.concatenate(got_j), np.concatenate(got_t)


@pytest.mark.parametrize("name", ["head_dim-64", "llama-tiny"])
def test_forward_cached_matches_reference_f32(name):
    """A 6-token prefill, then single-token decode steps; the RoPE of
    each slice starts at its lane's first position."""
    if name == "llama-tiny":
        config_j, config_t = jllama.CONFIGS[name], llama.CONFIGS[name]
    else:
        config_j, config_t = CFG_J, CFG_T
    tokens = np.random.default_rng(1).integers(0, 512, size=21).tolist()
    want, got = _cached_pair(config_j, config_t, tokens, prefill=6)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_forward_cached_matches_reference_bf16():
    """bf16 activations and KV pool.  bf16 rounds at other places in
    XLA:CPU and torch, and the logits here reach ~4, where one bf16 ulp
    is 2**-6: they differ by up to ~0.035 (two ulps), so the bound is
    2e-2 of the largest logit (measured 0.009 of it), as the gradients
    are bounded by their leaf's largest.  RoPE at position 0 for every
    slice moves them by 0.73 of it."""
    config_j = dataclasses.replace(CFG_J, dtype=jnp.bfloat16)
    config_t = dataclasses.replace(CFG_T, dtype=torch.bfloat16)
    tokens = np.random.default_rng(2).integers(0, 512, size=19).tolist()
    want, got = _cached_pair(config_j, config_t, tokens, prefill=6)
    assert _rel_err(got, want) <= 2e-2


def test_a_stage_mesh_trains_as_one_device(tmp_path):
    """seq runs (tests/test_torch_mesh_seq_expert.py); a stage mesh now
    builds too: its ranks are replicas (tests/test_torch_mesh_replicas
    .py holds them to the reference), so on stage = 2 each rank's losses
    are one device's.  A one-device mesh is one device."""
    from ray_tpu_torch.parallel import rank_bodies
    from ray_tpu_torch.parallel.launch import run_ranks

    tiny = llama.CONFIGS["llama-tiny"]
    batches = [_tokens(s, b=2, l=32) for s in (3, 4)]
    runs = run_ranks(rank_bodies.train, 2, args=(
        "llama", tiny, dict(stage=2), None, batches, LR, "cpu", False),
        device="cpu", init_dir=str(tmp_path), timeout_s=240)
    init, step = llama.make_train_step(tiny, adamw(LR), device="cpu")
    state, single = init(0), []
    for b in batches + batches[-1:]:
        state, m = step(state, {"tokens": torch.from_numpy(b)})
        single.append(float(m["loss"]))
    for out in runs:
        np.testing.assert_allclose(out["losses"] + [out["final_loss"]],
                                   single, rtol=1e-5)
    params = llama.init_params(tiny, device="cpu")
    tokens = {"tokens": torch.zeros(1, 8, dtype=torch.long)}
    one = types.SimpleNamespace(shape={"data": 1, "seq": 1})
    assert torch.isfinite(llama.loss_fn(params, tokens, tiny, one))


def test_params_from_numpy_takes_llama_and_rejects_a_wrong_tree():
    np_params = _np_params()
    params = params_from_numpy(np_params, CFG_T, device="cpu")
    own = llama.init_params(CFG_T, device="cpu")
    assert llama._map(own, lambda t: tuple(t.shape)) == \
        llama._map(params, lambda t: tuple(t.shape))
    for k, v in _flat(params_to_numpy(params)).items():
        np.testing.assert_array_equal(v, _flat(np_params)[k])
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(np_params, dataclasses.replace(CFG_T, d_ff=256),
                          device="cpu")
    extra = {**np_params, "pos_embed": np.zeros((128, 256), np.float32)}
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(extra, CFG_T, device="cpu")
    blocks = dict(np_params["blocks"])
    blocks["ln1_scale"] = blocks.pop("attn_norm")
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy({**np_params, "blocks": blocks}, CFG_T,
                          device="cpu")


def test_working_params_cast_once():
    """The engine's copy casts every matmul weight to the activation
    dtype and keeps the norm scales fp32."""
    config = dataclasses.replace(CFG_T, dtype=torch.bfloat16)
    work = llama.working_params(llama.init_params(config, device="cpu"),
                                config, device="cpu")
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        assert work["blocks"][k].dtype == torch.bfloat16, k
    assert work["tok_embed"].dtype == work["lm_head"].dtype == torch.bfloat16
    assert work["blocks"]["attn_norm"].dtype == torch.float32
    assert work["final_norm"].dtype == torch.float32
