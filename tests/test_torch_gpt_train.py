"""The port's GPT training path (ray_tpu_torch/models/gpt.py loss_fn and
models/_functional.py make_train_step) against the JAX reference on
shared weights: the loss and every gradient, then three AdamW steps
against optax.adamw.

The config has head_dim 64 (vocab 512, 2 layers, d_model 128, 2 heads,
d_ff 256, L 128) so that the reference really runs its Pallas flash
kernels (interpreted on the CPU); nano's head_dim 16 would send it to
its XLA attention."""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models._functional import AdamW, adamw
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.ops import attention as tattn

# Tiny tensors: one thread each keeps the parallel test workers from
# oversubscribing the host's cores.
torch.set_num_threads(1)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

SIZES = dict(vocab_size=512, n_layers=2, d_model=128, n_heads=2, d_ff=256,
             max_seq_len=128)
CFG_J = jgpt.GPTConfig(dtype=jnp.float32, **SIZES)
CFG_T = gpt.GPTConfig(dtype=torch.float32, **SIZES)
LR = 1e-4


@functools.cache
def _np_params():
    return jax.tree.map(np.asarray, jgpt.init_params(CFG_J,
                                                     jax.random.key(0)))


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
    params = gpt._map(params_from_numpy(np_params, config, device="cpu"),
                      lambda t: t.requires_grad_())
    loss = gpt.loss_fn(params, batch, config)
    leaves = _flat(params)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: g.numpy()
                                  for k, g in zip(leaves, grads)}


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_every_gradient_match_reference(masked):
    """f32: the port's plain flash and CE against the reference's Pallas
    flash (interpreted) and CE.  Per leaf, max |dg| / max |g| <= 1e-4:
    the same f32 arithmetic summed in other orders (measured below
    1e-5), while a wrong mask, target shift or missing term moves a
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
    want_loss, want_grads = jax.value_and_grad(jgpt.loss_fn)(
        jax.tree.map(jnp.asarray, np_params), batch_j, CFG_J)
    loss, grads = _port_loss_and_grads(np_params, batch_t)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, want_grads))
    assert set(grads) == set(want)
    for k in want:
        assert _rel_err(grads[k], want[k]) <= 1e-4, k


def test_loss_matches_reference_bf16():
    """bf16 activations: bf16 rounds at other places in XLA:CPU and
    torch, so the loss (about 6.2 here) agrees to 1e-3 relative."""
    cfg_j = dataclasses.replace(CFG_J, dtype=jnp.bfloat16)
    cfg_t = dataclasses.replace(CFG_T, dtype=torch.bfloat16)
    tokens = _tokens(3)
    want = jgpt.loss_fn(jax.tree.map(jnp.asarray, _np_params()),
                        {"tokens": jnp.asarray(tokens)}, cfg_j)
    got = gpt.loss_fn(params_from_numpy(_np_params(), cfg_t, device="cpu"),
                      {"tokens": torch.from_numpy(tokens)}, cfg_t)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-3)


def test_three_adamw_steps_match_optax():
    """Three steps of make_train_step with adamw(1e-4) against the
    reference's with optax.adamw(1e-4), from the same weights on the
    same batches.  atol 2 * lr per step: Adam's first steps move a
    weight by about lr * sign(g), so a gradient near 0 whose sign
    differs in the last bits moves it by up to 2 * lr."""
    init_j, step_j = jgpt.make_train_step(CFG_J, optax.adamw(LR))
    state_j = init_j(jax.random.key(0))
    step_j = jax.jit(step_j)
    init_t, step_t = gpt.make_train_step(CFG_T, adamw(LR), device="cpu")
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


def test_adamw_defaults_are_optax():
    """Known divergence: torch.optim.AdamW defaults weight_decay to 1e-2,
    optax.adamw to 1e-4; the port's factory holds optax's defaults."""
    opt = adamw(1e-4)
    assert opt == AdamW(1e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
    torch_opt = opt.init({"w": torch.zeros(2, requires_grad=True)})
    assert torch_opt.defaults["weight_decay"] == 1e-4
    assert torch.optim.AdamW([torch.zeros(1, requires_grad=True)]) \
        .defaults["weight_decay"] == 1e-2


def test_targets_are_rolled_and_last_position_masked():
    """Known divergence guard: targets = roll(tokens, -1) with the last
    position masked, so changing only the first token of each row moves
    the loss only through the inputs (position 0), never a target."""
    cfg = dataclasses.replace(CFG_T, n_layers=0)
    params = params_from_numpy(
        _np_params(), dataclasses.replace(CFG_T), device="cpu")
    params["blocks"] = {k: v[:0] for k, v in params["blocks"].items()}
    tokens = torch.from_numpy(_tokens(4, l=16))
    x, _ = gpt.forward_trunk(params, tokens, cfg)
    logp = torch.log_softmax(x @ params["tok_embed"].T, -1)
    nll = -logp[:, :-1].gather(2, tokens[:, 1:, None].long())[..., 0]
    torch.testing.assert_close(gpt.loss_fn(params, {"tokens": tokens}, cfg),
                               nll.mean(), atol=1e-6, rtol=1e-6)


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
    want, _ = jgpt.forward(jax.tree.map(jnp.asarray, _np_params()),
                           jnp.asarray(tokens), CFG_J, position_offset=32)
    got, aux = gpt.forward(params_from_numpy(_np_params(), CFG_T,
                                             device="cpu"),
                           torch.from_numpy(tokens), CFG_T,
                           position_offset=32)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_flash_kernel_path_is_taken():
    """head_dim 64, square causal: the block's attention is the
    autograd Function over K1-K3, not the reference fallback."""
    q = torch.zeros(1, 128, 2, 64, requires_grad=True)
    assert tattn.flash_attention(q, q, q).grad_fn.name() == \
        "_FlashAttentionBackward"


@pytest.mark.parametrize("name", ["nano", "gpt2-small", "7b"])
def test_num_params_matches_reference(name):
    assert gpt.num_params(gpt.CONFIGS[name]) == \
        jgpt.num_params(jgpt.CONFIGS[name])
    assert gpt.CONFIGS[name].remat == jgpt.CONFIGS[name].remat


def test_mesh_raises():
    tokens = {"tokens": torch.zeros(1, 8, dtype=torch.long)}
    nano = gpt.CONFIGS["nano"]
    params = gpt.init_params(nano, device="cpu")
    # data, fsdp, tensor, seq and expert run (tests/test_torch_mesh_train
    # .py, tests/test_torch_mesh_seq_expert.py); stage above 1 waits for
    # its item of ROADMAP A8.
    mesh = types.SimpleNamespace(shape={"data": 1, "stage": 2})
    with pytest.raises(NotImplementedError, match="multi-device"):
        gpt.loss_fn(params, tokens, nano, mesh)
    with pytest.raises(NotImplementedError, match="multi-device"):
        gpt.make_train_step(nano, adamw(1e-4), mesh, device="cpu")
    one = types.SimpleNamespace(shape={"data": 1, "tensor": 1})
    assert torch.isfinite(gpt.loss_fn(params, tokens, nano, one))


def test_moe_loss_is_finite_on_one_device():
    """The Switch MoE runs on one device, as the reference's does with
    no mesh (tests/test_torch_moe.py holds it to the reference)."""
    moe = gpt.CONFIGS["nano-moe"]
    tokens = {"tokens": torch.from_numpy(_tokens(7, l=32))}
    loss = gpt.loss_fn(gpt.init_params(moe, device="cpu"), tokens, moe)
    assert torch.isfinite(loss)


def test_train_step_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gpt.make_train_step(gpt.CONFIGS["nano"], adamw(1e-4))


def test_params_to_numpy_round_trip():
    back = params_to_numpy(params_from_numpy(_np_params(), CFG_T,
                                             device="cpu"))
    for k, v in _flat(_np_params()).items():
        np.testing.assert_array_equal(_flat(back)[k], v)
