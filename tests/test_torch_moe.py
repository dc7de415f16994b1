"""The port's Switch MoE (ray_tpu_torch/models/gpt.py `_moe_mlp`, single
device) against the JAX reference's dense one-hot dispatch on shared
weights: the loss, the load-balancing aux and every gradient, with and
without dropped tokens; three AdamW steps against optax.adamw; a tie in
the router, which both sides give to the first expert.

Tolerances (f32): the loss within 1e-5 relative and every gradient
within 1e-4 of its leaf's largest, as tests/test_torch_gpt_train.py
holds the dense model (the sums run in other orders); aux within 1e-6
relative (one mean of a softmax)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models._functional import adamw
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

LR = 1e-4
# nano-moe as the reference defines it (head dim 16: both sides take
# their plain attention), and at head dim 64, where the reference runs
# its Pallas flash kernels interpreted and the port the plain K1-K3.
CONFIGS = {
    "nano-moe": (jgpt.CONFIGS["nano-moe"], gpt.CONFIGS["nano-moe"]),
    "moe-d64": tuple(dataclasses.replace(c, d_model=128, n_heads=2,
                                         d_ff=256)
                     for c in (jgpt.CONFIGS["nano-moe"],
                               gpt.CONFIGS["nano-moe"])),
}


def _configs(name, capacity_factor=None):
    cj, ct = CONFIGS[name]
    if capacity_factor is not None:
        cj = dataclasses.replace(cj, capacity_factor=capacity_factor)
        ct = dataclasses.replace(ct, capacity_factor=capacity_factor)
    return cj, ct


@functools.cache
def _np_params(name):
    cj = CONFIGS[name][0]
    return jax.tree.map(np.asarray, jgpt.init_params(cj, jax.random.key(0)))


def _tokens(seed, b=2, l=64):
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
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / \
        max(np.abs(want).max(), 1e-30)


def _dropped(name, capacity_factor, tokens):
    """Tokens the port's router drops, over every layer."""
    ct = _configs(name, capacity_factor)[1]
    params = params_from_numpy(_np_params(name), ct, device="cpu")
    dropped = 0

    def count(x, router, w_up, w_down, config, *plan):
        nonlocal dropped
        _, _, _, rank, cap = gpt._route(x.reshape(-1, x.shape[-1]), router,
                                        config)
        dropped += int((rank >= cap).sum())
        return original(x, router, w_up, w_down, config, *plan)

    original, gpt._moe_mlp = gpt._moe_mlp, count
    try:
        gpt.forward_trunk(params, torch.from_numpy(tokens), ct)
    finally:
        gpt._moe_mlp = original
    return dropped


@pytest.mark.parametrize("name,capacity_factor", [
    ("nano-moe", None), ("nano-moe", 0.5), ("moe-d64", None)])
def test_loss_aux_and_every_gradient_match_reference(name, capacity_factor):
    cj, ct = _configs(name, capacity_factor)
    tokens = _tokens(1)
    if capacity_factor is not None:
        assert _dropped(name, capacity_factor, tokens) > 0
    want_loss, want_grads = jax.value_and_grad(jgpt.loss_fn)(
        jax.tree.map(jnp.asarray, _np_params(name)),
        {"tokens": jnp.asarray(tokens)}, cj)
    params = gpt._map(params_from_numpy(_np_params(name), ct, device="cpu"),
                      lambda t: t.requires_grad_())
    loss = gpt.loss_fn(params, {"tokens": torch.from_numpy(tokens)}, ct)
    leaves = _flat(params)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, want_grads))
    assert set(grads) == set(want)
    for k in want:
        assert _rel_err(grads[k].numpy(), want[k]) <= 1e-4, k


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_aux_matches_reference(capacity_factor):
    cj, ct = _configs("nano-moe", capacity_factor)
    tokens = _tokens(2)
    _, want = jgpt.forward(jax.tree.map(jnp.asarray, _np_params("nano-moe")),
                           jnp.asarray(tokens), cj)
    _, got = gpt.forward(params_from_numpy(_np_params("nano-moe"), ct,
                                           device="cpu"),
                         torch.from_numpy(tokens), ct)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # Each layer's aux lies in [1, e]; the trunk sums the layers'.
    e, n = ct.n_experts, ct.n_layers
    assert n <= float(got) <= n * e


def test_three_adamw_steps_match_optax():
    """Each step's loss within 1e-5 relative, a fourth loss too (it
    reads the third update), and every leaf's total update within
    0.05 * lr of optax's: Adam divides each gradient element by its own
    scale, so an element near zero, where the two sides' sums differ by
    up to 1e-4 of the leaf's largest, moves by a different fraction of lr
    (0.036 lr at most here).  A skipped update or a wrong bias
    correction moves a weight by 0.1 lr or more."""
    cj, ct = _configs("nano-moe", 0.5)
    init_j, step_j = jgpt.make_train_step(cj, optax.adamw(LR))
    state_j = init_j(jax.random.key(0))
    step_j = jax.jit(step_j)
    start = jax.tree.map(np.array, state_j["params"])
    init_t, step_t = gpt.make_train_step(ct, adamw(LR), device="cpu")
    state_t = init_t(params=params_from_numpy(start, ct, device="cpu"))
    for i in range(4):
        if i == 3:
            _assert_updates_match(
                _flat(start), _flat(params_to_numpy(state_t["params"])),
                _flat(jax.tree.map(np.asarray, state_j["params"])), LR)
        tokens = _tokens(10 + i)
        state_j, m_j = step_j(state_j, {"tokens": jnp.asarray(tokens)})
        state_t, m_t = step_t(state_t, {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=1e-5)


def _assert_updates_match(start, got, want, lr):
    """Every leaf's update (`got` or `want` less `start`) within 0.05 *
    lr of the reference's."""
    assert set(got) == set(want)
    for k in want:
        base = np.asarray(start[k], np.float64)
        np.testing.assert_allclose(np.asarray(got[k], np.float64) - base,
                                   np.asarray(want[k], np.float64) - base,
                                   atol=0.05 * lr, rtol=0, err_msg=k)


def _routing_per_layer(module, run):
    """Each layer's (aux, share of tokens dropped) while `run()` drives
    `module`'s (the reference's or the port's) own `_moe_mlp`: a dropped
    token's output row is exactly zero on both sides."""
    seen = []
    original = module._moe_mlp

    def record(*args):
        out, aux = original(*args)
        share = (out == 0).all(-1).mean(dtype=out.dtype) \
            if module is gpt else jnp.mean(jnp.all(out == 0, -1))
        if module is gpt:
            seen.append((float(aux), float(share)))
        else:
            jax.debug.callback(lambda a, d: seen.append((float(a),
                                                         float(d))),
                               aux, share, ordered=True)
        return out, aux

    module._moe_mlp = record
    try:
        run()
    finally:
        module._moe_mlp = original
    return seen


def test_routing_per_layer_at_gpt2_small_widths_matches_reference():
    """gpt2-small's widths with 8 experts at 3 layers (f32), the
    reference's random weights carried across, 2 x 1024 random tokens:
    each layer's aux (within 1e-5 relative) and share of dropped tokens
    (equal) are the reference's, so the imbalance that a model at random
    weights shows is the model's own, not the port's."""
    cj = dataclasses.replace(jgpt.CONFIGS["gpt2-small"], n_layers=3,
                             n_experts=8, dtype=jnp.float32)
    ct = dataclasses.replace(gpt.CONFIGS["gpt2-small"], n_layers=3,
                             n_experts=8, dtype=torch.float32)
    params = jax.tree.map(np.asarray, jgpt.init_params(cj,
                                                       jax.random.key(3)))
    tokens = np.random.default_rng(4).integers(
        0, cj.vocab_size, (2, 1024)).astype(np.int32)
    want = _routing_per_layer(jgpt, lambda: jax.jit(
        functools.partial(jgpt.forward_trunk, config=cj))(
            params, jnp.asarray(tokens))[1].block_until_ready())
    got = _routing_per_layer(gpt, lambda: gpt.forward_trunk(
        params_from_numpy(params, ct, device="cpu"),
        torch.from_numpy(tokens), ct))
    print("per-layer (aux, dropped share): reference", want, "port", got)
    assert len(got) == len(want) == 3
    for (aux_t, drop_t), (aux_j, drop_j) in zip(got, want):
        np.testing.assert_allclose(aux_t, aux_j, rtol=1e-5)
        assert drop_t == drop_j


def test_router_tie_takes_the_first_expert():
    """Router columns 1 and 2 equal, 0 and 3 their negation: every token
    ties, between experts 1 and 2 or between 0 and 3, and both sides
    route it to the first of the pair.  The output and the gradients
    (the gate's split evenly among the tied maxima on both sides) match
    the reference's."""
    cj, ct = _configs("nano-moe")
    rng = np.random.default_rng(3)
    d, f, e = ct.d_model, ct.d_ff, ct.n_experts
    col = rng.standard_normal((d, 1)).astype(np.float32)
    router = np.concatenate([-col, col, col, -col], axis=1)
    w_up = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    w_down = (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32)
    x = rng.standard_normal((2, 16, d)).astype(np.float32)

    def ref(x, router, w_up, w_down):
        out, aux = jgpt._moe_mlp(x, router, w_up, w_down, cj, None)
        return jnp.sum(out * out) + aux

    want_val, want_grads = jax.value_and_grad(ref, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, router, w_up, w_down)))
    args = [torch.from_numpy(a).requires_grad_()
            for a in (x, router, w_up, w_down)]
    _, _, expert, _, _ = gpt._route(args[0].reshape(-1, d), args[1], ct)
    assert set(expert.tolist()) == {0, 1}
    out, aux = gpt._moe_mlp(*args, ct)
    val = torch.sum(out * out) + aux
    grads = torch.autograd.grad(val, args)
    np.testing.assert_allclose(float(val.detach()), float(want_val),
                               rtol=1e-5)
    for got, want in zip(grads, want_grads):
        assert _rel_err(got.numpy(), np.asarray(want)) <= 1e-5


def test_cached_decode_rejects_moe():
    ct = gpt.CONFIGS["nano-moe"]
    with pytest.raises(NotImplementedError, match="dense MLP only"):
        gpt.forward_cached({}, None, None, None, None, None, None, None, ct)
