"""The port's ResNet (ray_tpu_torch/models/resnet.py) against the flax
reference on shared weights, at narrow widths (width 8, stage_sizes
(1, 1), 16 x 16 inputs, 2 groups), for both stems and both block kinds:
the 7x7/2 SAME stem, the SAME max-pool and the stride-2 1x1 residual
projection are all exercised.  Logits, loss, accuracy and every
gradient, then three AdamW steps against optax.adamw.

Tolerances (f32): logits and loss within 1e-5 relative (the convolutions
sum in other orders), every gradient within 1e-4 of its leaf's largest;
bf16: logits within 2e-2 of the largest (both sides round the
activations to bf16 after every conv and norm, in other places)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import resnet as jresnet
from ray_tpu_torch.models import resnet
from ray_tpu_torch.models._functional import adamw
from ray_tpu_torch.models.convert import resnet_state_dict, resnet_variables

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

SHAPE = (16, 16, 3)
KINDS = {f"{'bottleneck' if b else 'basic'}-{'cifar' if c else 'imagenet'}":
         dict(bottleneck=b, cifar_stem=c)
         for b in (False, True) for c in (True, False)}


def _configs(kind, dtype=(jnp.float32, torch.float32)):
    kw = dict(stage_sizes=(1, 1), width=8, num_groups=2, num_classes=10,
              **KINDS[kind])
    return (jresnet.ResNetConfig(dtype=dtype[0], **kw),
            resnet.ResNetConfig(dtype=dtype[1], **kw))


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b,) + SHAPE).astype(np.float32),
            rng.integers(0, 10, (b,)).astype(np.int32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _rel_err(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / \
        max(np.abs(want).max(), 1e-30)


def _ref(kind, dtype=(jnp.float32, torch.float32)):
    cj, ct = _configs(kind, dtype)
    init, apply = jresnet.make_model(cj, SHAPE)
    variables = jax.tree.map(np.asarray, init(jax.random.key(0)))
    model = resnet.ResNet(ct)
    model.load_state_dict(resnet_state_dict(variables, ct, device="cpu"))
    return variables, apply, model


@pytest.mark.parametrize("kind", KINDS)
def test_logits_loss_accuracy_and_every_gradient_match_flax(kind):
    variables, apply, model = _ref(kind)
    images, labels = _batch(1)

    def loss_fn(v):
        logits = apply(v, jnp.asarray(images))
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None],
                                   axis=-1)[:, 0]
        return nll.mean(), logits

    (want_loss, want_logits), want_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree.map(jnp.asarray, variables))
    logits = model(torch.from_numpy(images))
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    grads = _flat(resnet_variables(_grad_model(model)))
    want = _flat(jax.tree.map(np.asarray, want_grads))
    assert set(grads) == set(want)
    for k in want:
        assert _rel_err(grads[k], want[k]) <= 1e-4, k


def _grad_model(model):
    """A copy of `model` whose parameters are the gradients."""
    grads = resnet.ResNet(model.config)
    grads.load_state_dict({k: p.grad for k, p in model.named_parameters()})
    return grads


def test_bf16_logits_match_flax():
    variables, apply, model = _ref("bottleneck-imagenet",
                                   (jnp.bfloat16, torch.bfloat16))
    images, _ = _batch(2)
    want = np.asarray(jax.jit(apply)(jax.tree.map(jnp.asarray, variables),
                                     jnp.asarray(images)))
    got = model(torch.from_numpy(images)).detach().numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_three_adamw_steps_match_optax():
    """Each step's loss within 1e-5 relative and its accuracy equal, a
    fourth loss too (it reads the third update), and every leaf's total
    update within 0.05 * lr of optax's (2.4e-4 lr measured here; a
    skipped update or a wrong bias correction moves a weight by 0.1 lr
    or more)."""
    lr = 1e-3
    cj, ct = _configs("bottleneck-imagenet")
    init_j, step_j = jresnet.make_train_step(cj, optax.adamw(lr),
                                             input_shape=SHAPE)
    state_j = init_j(jax.random.key(0))
    step_j = jax.jit(step_j)
    start = jax.tree.map(np.array, state_j["params"])
    init_t, step_t = resnet.make_train_step(ct, adamw(lr), device="cpu")
    state_t = init_t(params=resnet_state_dict(start, ct, device="cpu"))
    for i in range(4):
        if i == 3:
            assert state_t["step"] == 3
            got = _flat(resnet_variables(state_t["params"]))
            want = _flat(jax.tree.map(np.asarray, state_j["params"]))
            assert set(got) == set(want)
            for k in want:
                base = np.asarray(_flat(start)[k], np.float64)
                np.testing.assert_allclose(
                    np.asarray(got[k], np.float64) - base,
                    np.asarray(want[k], np.float64) - base,
                    atol=0.05 * lr, rtol=0, err_msg=k)
        images, labels = _batch(10 + i)
        state_j, m_j = step_j(state_j, {"images": jnp.asarray(images),
                                        "labels": jnp.asarray(labels)})
        state_t, m_t = step_t(state_t, {"images": torch.from_numpy(images),
                                        "labels": torch.from_numpy(labels)})
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=1e-5)
        assert float(m_t["accuracy"]) == float(m_j["accuracy"])


@pytest.mark.parametrize("name", list(jresnet.CONFIGS))
def test_configs_and_num_params_match_reference(name):
    cj, ct = jresnet.CONFIGS[name], resnet.CONFIGS[name]
    fields = [f.name for f in dataclasses.fields(cj) if f.name != "dtype"]
    assert [getattr(ct, f) for f in fields] == [getattr(cj, f)
                                                for f in fields]
    assert str(ct.dtype).split(".")[-1] == jnp.dtype(cj.dtype).name
    assert resnet.num_params(ct) == jresnet.num_params(cj)


def test_same_padding_matches_xla():
    """_same against lax.padtype_to_pads for every (n, k, s) the
    configs meet, odd sizes included."""
    for n in (7, 8, 15, 16, 224, 112, 56):
        for k, s in ((1, 1), (1, 2), (3, 1), (3, 2), (7, 2)):
            want = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
            assert resnet._same(n, k, s) == tuple(want), (n, k, s)


def test_make_model_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resnet.make_model(resnet.CONFIGS["resnet18-cifar"])
