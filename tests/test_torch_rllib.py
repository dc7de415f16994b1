"""The port's rllib (ray_tpu_torch/rllib/) against the reference's
(ray_tpu/rllib/), on the CPU at nano sizes:

- the environment copies give the reference's episodes bit for bit from
  the same seed; `compute_gae` equals the reference's;
- the MLP and the Nature-CNN give flax's logits and values within 1e-5
  on the same weights, and a conv model built with PyTorch's own padding
  or flattened in NCHW fails that check; the weights round-trip through
  `convert` bit for bit;
- the policy's greedy actions are exact and its log-probs of the actions
  it drew within 1e-6; a greedy evaluation gives the reference's returns;
- PPO: `ppo_loss` and every gradient against `jax.value_and_grad`; the
  clipped gradients against optax's `clip_by_global_norm` within 2e-6
  relative (torch's `clip_grad_norm_`, `max_norm / (norm + 1e-6)`, must
  miss that); three `TorchLearner` steps against optax by update, at
  0.05 * lr, with the clipping engaged, and the first step's clipped
  norm within 2e-7 (which a learner on `clip_grad_norm_` misses);
- the V-trace learner (MLP and Nature-CNN, terminations and truncations
  in the batch): loss and every gradient against the reference's
  `_VTraceLearner`, then three updates compared by update at 0.05 * lr;
- the rollout worker's value-based knobs (epsilon schedule, an
  exploration strategy, obs and action connectors) giving the reference
  worker's fragments;
- the PPO driver with no remote workers, its state crossing from the
  reference's learner; every entry point (those of the continuous,
  recurrent and off-policy algorithms too) raising without a card unless
  given device="cpu", and a mesh raising.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.rllib import connectors as jconn
from ray_tpu.rllib import env as jenv
from ray_tpu.rllib import exploration as jexp
from ray_tpu.rllib.impala import IMPALAConfig as JIMPALAConfig
from ray_tpu.rllib.impala import _VTraceLearner as JVTraceLearner
from ray_tpu.rllib.learner import JaxLearner, ppo_loss as jppo_loss
from ray_tpu.rllib.models import make_model as jmake_model
from ray_tpu.rllib.policy import JaxPolicy
from ray_tpu.rllib.rollout_worker import RolloutWorker as JRolloutWorker
from ray_tpu.rllib.sample_batch import compute_gae as jcompute_gae
from ray_tpu_torch.models import convert
from ray_tpu_torch.models.resnet import _same
from ray_tpu_torch.rllib import (PPOConfig, RolloutWorker, SampleBatch,
                                 TorchLearner, TorchPolicy, compute_gae,
                                 make_model, ppo_loss)
from ray_tpu_torch.rllib import connectors as pconn
from ray_tpu_torch.rllib import env as penv
from ray_tpu_torch.rllib import exploration as pexp
from ray_tpu_torch.rllib import (A2CConfig, DeterministicNoiseRolloutPolicy,
                                 DQNConfig, RecurrentTorchPolicy, SACConfig,
                                 SquashedGaussianRolloutPolicy, TD3Config)
from ray_tpu_torch.rllib import (BC, CQL, MARWIL, MultiAgentRolloutWorker,
                                 PolicyServer, QMixConfig, VDNConfig, fit_fqe)
from ray_tpu_torch.rllib.dqn import _QLearner
from ray_tpu_torch.rllib.impala import IMPALAConfig, _VTraceLearner
from ray_tpu_torch.rllib.sac import _SACLearner
from ray_tpu_torch.rllib.td3 import _TD3Learner
from ray_tpu_torch.rllib.learner import clip_by_global_norm

torch.set_num_threads(1)

PIXEL = (84, 84, 4)
HIDDEN = (16, 16)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves(_np(tree))


def _flax_params(obs_dim, num_actions, seed=0):
    init, apply = jmake_model(obs_dim, num_actions, HIDDEN)
    return _np(init(jax.random.key(seed))), apply


def _port_model(obs_dim, num_actions, variables):
    m = make_model(obs_dim, num_actions, HIDDEN, device="cpu")
    m.load_state_dict(convert.actor_critic_state_dict(variables, m))
    return m


def _pixels(rng, n):
    return rng.integers(0, 256, size=(n,) + PIXEL).astype(np.uint8)


# ---------------------------------------------------------------- envs

@pytest.mark.parametrize("name", ["CartPole-v1", "SyntheticPixel-v0"])
def test_env_copies_give_the_references_episodes(name):
    ref = jenv.make_vector_env(name, 6, seed=3)
    port = penv.make_vector_env(name, 6, seed=3)
    np.testing.assert_array_equal(ref.reset_all(3), port.reset_all(3))
    rng = np.random.default_rng(0)
    steps = 140 if name == "SyntheticPixel-v0" else 300
    for _ in range(steps):
        a = rng.integers(0, ref.num_actions, size=6)
        for x, y in zip(ref.step(a), port.step(a)):
            np.testing.assert_array_equal(x, y)
    assert ref.drain_episode_metrics() == port.drain_episode_metrics()
    assert port.completed_returns == [] and ref.num_envs == port.num_envs


def test_compute_gae_matches_reference():
    rng = np.random.default_rng(1)
    T, B = 12, 5
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    dones = rng.random((T, B)) < 0.2
    boot = rng.normal(size=B).astype(np.float32)
    for x, y in zip(compute_gae(rewards, values, dones, boot, 0.99, 0.95),
                    jcompute_gae(rewards, values, dones, boot, 0.99, 0.95)):
        np.testing.assert_array_equal(x, y)


# -------------------------------------------------------------- models

def _max_err(model_out, ref_out):
    return max(float(np.abs(a.detach().numpy() - np.asarray(b)).max())
               for a, b in zip(model_out, ref_out))


@pytest.mark.parametrize("obs_dim", [4, PIXEL], ids=["mlp", "nature_cnn"])
def test_models_match_flax(obs_dim):
    rng = np.random.default_rng(2)
    variables, apply = _flax_params(obs_dim, 4, seed=5)
    m = _port_model(obs_dim, 4, variables)
    x = (_pixels(rng, 3) if obs_dim == PIXEL
         else rng.normal(size=(7, 4)).astype(np.float32))
    assert _max_err(m(torch.from_numpy(x)), apply(variables, x)) <= 1e-5
    # Round trip: the port's state dict as flax's tree, bit for bit.
    for a, b in zip(_leaves(convert.actor_critic_variables(m)),
                    _leaves(variables)):
        np.testing.assert_array_equal(a, b)


def _torch_style_cnn(m, obs, padding, nchw_flatten):
    """The Nature-CNN on the port's weights with other conventions:
    `padding` "same" pads as flax does, a tuple of ints pads each conv
    symmetrically (PyTorch's `padding=`); `nchw_flatten` flattens
    channels first."""
    x = obs.float().div(255.0).permute(0, 3, 1, 2)
    for i in range(3):
        conv = getattr(m, f"Conv_{i}")
        if padding == "same":
            k, s = conv.kernel_size[0], conv.stride[0]
            (t, b), (left, right) = (_same(x.shape[2], k, s),
                                     _same(x.shape[3], k, s))
            x = F.conv2d(F.pad(x, (left, right, t, b)), conv.weight,
                         conv.bias, conv.stride)
        else:
            x = F.conv2d(x, conv.weight, conv.bias, conv.stride, padding[i])
        x = F.relu(x)
    if not nchw_flatten:
        x = x.permute(0, 2, 3, 1)
    x = F.relu(m.Dense_0(x.reshape(x.shape[0], -1)))
    return m.Dense_1(x), m.Dense_2(x)[..., 0]


def test_nature_cnn_needs_same_padding_and_nhwc_flatten():
    """flax's SAME pads (2, 2), (1, 2), (1, 1): 84 -> 21 -> 11 -> 11.
    PyTorch's default (no padding) gives 84 -> 20 -> 9 -> 7 and cannot
    meet the 7,744-input Dense at all; symmetric padding (2, 2, 1)
    reaches the same shapes but pads the second conv on the wrong side;
    an NCHW flatten feeds the Dense its inputs in another order.  Each
    must miss flax's output."""
    assert [_same(n, k, s) for n, k, s in ((84, 8, 4), (21, 4, 2),
                                           (11, 3, 1))] == [
        (2, 2), (1, 2), (1, 1)]
    rng = np.random.default_rng(3)
    variables, apply = _flax_params(PIXEL, 4, seed=6)
    m = _port_model(PIXEL, 4, variables)
    x = _pixels(rng, 2)
    ref = apply(variables, x)
    obs = torch.from_numpy(x)
    with torch.no_grad():
        assert _max_err(m(obs), ref) <= 1e-5
        assert _max_err(_torch_style_cnn(m, obs, "same", False), ref) <= 1e-5
        with pytest.raises(RuntimeError):      # 3,136 inputs, not 7,744
            _torch_style_cnn(m, obs, (0, 0, 0), False)
        assert _max_err(_torch_style_cnn(m, obs, (2, 2, 1), False),
                        ref) > 1e-3
        assert _max_err(_torch_style_cnn(m, obs, "same", True), ref) > 1e-3


def test_actor_critic_state_dict_checks_names_and_shapes():
    variables, _ = _flax_params(4, 2)
    m = make_model(4, 2, (8,), device="cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.actor_critic_state_dict(variables, m)
    wrong = make_model(5, 2, HIDDEN, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.actor_critic_state_dict(variables, wrong)


# -------------------------------------------------------------- policy

@pytest.mark.parametrize("obs_dim", [4, PIXEL], ids=["mlp", "nature_cnn"])
def test_policy_greedy_exact_and_logps_of_its_draws(obs_dim):
    rng = np.random.default_rng(4)
    jp = JaxPolicy(obs_dim, 4, HIDDEN, seed=0)
    pp = TorchPolicy(obs_dim, 4, HIDDEN, seed=0, device="cpu")
    pp.set_weights(jp.get_weights())
    x = (_pixels(rng, 6) if obs_dim == PIXEL
         else rng.normal(size=(64, 4)).astype(np.float32))
    ja, _, jv, _ = jp.compute_actions(x, explore=False)
    pa, plp, pv, _ = pp.compute_actions(x, explore=False)
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_allclose(pv, jv, atol=1e-5, rtol=1e-5)
    assert (plp == 0).all()
    a, logp, _, _ = pp.compute_actions(x)
    logits, _ = jp.apply(jp.params, jnp.asarray(x))
    want = np.asarray(jax.nn.log_softmax(logits))[np.arange(len(x)), a]
    np.testing.assert_allclose(logp, want, atol=1e-6, rtol=0)
    # Seeded: a second policy from the same seed draws the same actions.
    again = TorchPolicy(obs_dim, 4, HIDDEN, seed=0, device="cpu")
    again.set_weights(jp.get_weights())
    np.testing.assert_array_equal(again.compute_actions(x)[0], a)


def test_greedy_evaluation_gives_the_references_returns():
    kw = dict(num_envs=4, rollout_fragment_length=8, hidden=HIDDEN, seed=2)
    ref = JRolloutWorker("CartPole-v1", **kw)
    port = RolloutWorker("CartPole-v1", device="cpu", **kw)
    port.set_weights(ref.get_weights())
    r1 = ref.evaluate(num_episodes=6, max_steps=600)
    r2 = port.evaluate(num_episodes=6, max_steps=600)
    assert r1["episode_returns"] and r1 == r2


@pytest.mark.parametrize("postprocess", [True, False])
def test_rollout_worker_layouts_match_reference(postprocess):
    kw = dict(num_envs=4, rollout_fragment_length=8, hidden=HIDDEN,
              postprocess=postprocess)
    for name in ("CartPole-v1", "SyntheticPixel-v0"):
        rb, rm = JRolloutWorker(name, **kw).sample()
        pb, pm = RolloutWorker(name, device="cpu", **kw).sample()
        assert {k: (v.shape, v.dtype) for k, v in pb.items()} == \
            {k: (v.shape, v.dtype) for k, v in rb.items()}
        assert pm["env_steps"] == rm["env_steps"] == 32
        if not postprocess:
            np.testing.assert_array_equal(pb["obs"][0], rb["obs"][0])


def _knob_case(knob, pkg):
    """(env, worker kwargs) that exercise one value-based knob with the
    objects of one package (`pkg` "ref" or "port"); the actions the env
    sees come from the worker's numpy generator (epsilon 1, or the
    uniform warm-up), so both packages step the same episodes."""
    conn, exp = (jconn, jexp) if pkg == "ref" else (pconn, pexp)
    all_random = {"epsilon_schedule": (1.0, 1.0, 1)}
    return {
        "epsilon_schedule": ("CartPole-v1",
                             {"epsilon_schedule": (1.0, 0.2, 48)}),
        "exploration": ("CartPole-v1",
                        {"exploration": exp.EpsilonGreedy(2, 1.0, 1.0, 1)}),
        "obs_connector": ("CartPole-v1",
                          dict(all_random, obs_connector=conn.
                               ConnectorPipeline([conn.NormalizeObs(),
                                                  conn.ClipObs(-2, 2)]))),
        "action_connector": ("Pendulum-v1",
                             {"random_warmup_steps": 10 ** 6,
                              "action_connector": conn.ClipActions(-0.5,
                                                                   0.5)}),
    }[knob]


@pytest.mark.parametrize("knob", ["epsilon_schedule", "exploration",
                                  "obs_connector", "action_connector"])
def test_rollout_worker_value_knobs_give_the_references_fragments(knob):
    """Each value-based knob gives the reference worker's fragments: two
    fragments from the same weights, with the knob's objects from each
    package: obs, actions, rewards and episode ends exactly, the
    policy's outputs within 1e-5."""
    env, kw_ref = _knob_case(knob, "ref")
    _, kw_port = _knob_case(knob, "port")
    kw = dict(num_envs=4, rollout_fragment_length=8, hidden=HIDDEN, seed=1,
              postprocess=False)
    ref = JRolloutWorker(env, **kw, **kw_ref)
    port = RolloutWorker(env, device="cpu", **kw, **kw_port)
    port.set_weights(ref.get_weights())
    for _ in range(2):
        rb, rm = ref.sample()
        pb, pm = port.sample()
        assert set(pb) == set(rb)
        for k in ("obs", "actions", "rewards", "terminateds", "truncateds",
                  "bootstrap_obs"):
            np.testing.assert_array_equal(pb[k], rb[k])
        if knob == "epsilon_schedule":        # greedy Q, then epsilon
            np.testing.assert_allclose(pb["action_logits"],
                                       rb["action_logits"], rtol=1e-5,
                                       atol=1e-6)
        assert pm["episode_returns"] == rm["episode_returns"]
    if knob == "action_connector":           # the batch keeps raw actions
        assert np.abs(pb["actions"]).max() > 0.5


# ----------------------------------------------------------------- PPO

PPO_CFG = {"clip_param": 0.2, "vf_clip_param": 10.0, "vf_loss_coeff": 0.5,
           "entropy_coeff": 0.01}


def _ppo_batch(rng, n=48, obs_dim=4):
    return SampleBatch({
        SampleBatch.OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, 2, n).astype(np.int32),
        SampleBatch.ACTION_LOGP: rng.uniform(-1.2, -0.3, n).astype(
            np.float32),
        SampleBatch.ADVANTAGES: rng.normal(size=n).astype(np.float32),
        SampleBatch.VALUE_TARGETS: (3 * rng.normal(size=n)).astype(
            np.float32),
    })


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _grads(model, loss):
    """{state-dict name: gradient} of `loss` over the model's params."""
    names = [n for n, _ in model.named_parameters()]
    return dict(zip(names, torch.autograd.grad(loss, list(
        model.parameters()))))


def _assert_trees_close(got, want, rtol, atol):
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_ppo_loss_and_gradients_match_jax():
    rng = np.random.default_rng(5)
    variables, apply = _flax_params(4, 2, seed=1)
    mb = _ppo_batch(rng)
    (jloss, jmet), jgrads = jax.value_and_grad(
        functools.partial(jppo_loss, apply), has_aux=True)(
            variables, {k: jnp.asarray(v) for k, v in mb.items()}, PPO_CFG)
    m = _port_model(4, 2, variables)
    loss, met = ppo_loss(m, _tensors(mb), PPO_CFG)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    for k in jmet:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]),
                                   rtol=1e-5, atol=1e-7)
    grads = convert.actor_critic_variables(_grads(m, loss))
    _assert_trees_close(grads, jgrads, rtol=1e-5, atol=1e-7)


def _torch_clip(grads, max_norm):
    """torch.nn.utils.clip_grad_norm_'s scaling: max_norm / (norm + 1e-6),
    applied whenever that is below 1.  It clips the `.grad` of what it
    is given, so each gradient rides a stand-in parameter."""
    ps = [torch.zeros_like(g, requires_grad=True) for g in grads]
    for p, g in zip(ps, grads):
        p.grad = g.detach().clone()
    torch.nn.utils.clip_grad_norm_(ps, max_norm)
    return [p.grad for p in ps]


def test_clipped_gradients_match_optax():
    rng = np.random.default_rng(6)
    variables, _ = _flax_params(4, 2, seed=2)
    m = _port_model(4, 2, variables)
    # A small value term keeps the global norm well under 1, where the
    # +1e-6 of torch's clip_grad_norm_ is a relative 1e-6 / norm.
    loss, _ = ppo_loss(m, _tensors(_ppo_batch(rng)),
                       dict(PPO_CFG, vf_loss_coeff=0.01))
    named = _grads(m, loss)
    grads = list(named.values())
    tree = convert.actor_critic_variables(named)
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads)))

    def as_tree(gs):
        return convert.actor_critic_variables(dict(zip(named, gs)))

    for max_norm in (0.5 * norm, 2.0 * norm):     # clipped, and not
        want, _ = optax.clip_by_global_norm(max_norm).update(tree, None)
        _assert_trees_close(as_tree(clip_by_global_norm(grads, max_norm)),
                            want, rtol=2e-6, atol=0)
    # The +1e-6 of torch's clip_grad_norm_ shows at this tolerance.
    assert norm < 0.25
    want, _ = optax.clip_by_global_norm(0.5 * norm).update(tree, None)
    with pytest.raises(AssertionError):
        _assert_trees_close(as_tree(_torch_clip(grads, 0.5 * norm)), want,
                            rtol=2e-6, atol=0)


def _assert_updates_close(before, after_port, after_ref, lr):
    """Per leaf, the two packages' updates within 0.05 * lr."""
    for b, p, r in zip(_leaves(before), _leaves(after_port),
                       _leaves(after_ref)):
        np.testing.assert_allclose(p - b, r - b, rtol=0, atol=0.05 * lr)


def _learner_against_optax(lr=1e-2, grad_clip=0.05):
    """Three TorchLearner minibatch steps against optax's, each compared
    by update at 0.05 * lr, on batches whose raw gradient norms differ
    (so the moments mix differently scaled gradients) and all exceed
    grad_clip.  After the first step from zero moments, mu is
    (1 - b1) times the clipped gradient, whose global norm optax puts at
    exactly grad_clip: checked within 2e-7 relative, where torch's
    max_norm / (norm + 1e-6) falls short by 1e-6 / norm."""
    rng = np.random.default_rng(7)
    cfg = dict(PPO_CFG, lr=lr, grad_clip=grad_clip, num_sgd_iter=1,
               sgd_minibatch_size=64)
    ref = JaxLearner(4, 2, loss_fn=jppo_loss, config=cfg, hidden=HIDDEN,
                     seed=3)
    port = TorchLearner(4, 2, loss_fn=ppo_loss, config=cfg, hidden=HIDDEN,
                        seed=3, device="cpu")
    port.set_state(_np(ref.get_state()))
    for step in range(3):
        batch = _ppo_batch(rng, n=64)
        batch[SampleBatch.ADVANTAGES] *= 1 + 3 * step
        _, jgrads = jax.value_and_grad(
            functools.partial(jppo_loss, ref.apply), has_aux=True)(
                ref.params, {k: jnp.asarray(v) for k, v in batch.items()},
                cfg)
        assert float(optax.global_norm(jgrads)) > 2 * grad_clip
        ref_before, port_before = ref.get_weights(), port.get_weights()
        rm = ref.update(batch)
        pm = port.update(batch)
        np.testing.assert_allclose(pm["total_loss"], rm["total_loss"],
                                   rtol=1e-5)
        for pb, pa, rb, ra in zip(_leaves(port_before),
                                  _leaves(port.get_weights()),
                                  _leaves(ref_before),
                                  _leaves(ref.get_weights())):
            np.testing.assert_allclose(pa - pb, ra - rb, rtol=0,
                                       atol=0.05 * lr)
        adam = port.get_state()["opt_state"][1][0]
        if step == 0:
            mu_norm = np.sqrt(sum(np.sum(x.astype(np.float64) ** 2)
                                  for x in _leaves(adam.mu)))
            np.testing.assert_allclose(mu_norm, (1 - 0.9) * grad_clip,
                                       rtol=2e-7)
    assert int(adam.count) == 3 == int(ref.get_state()["opt_state"][1][
        0].count)


def test_torch_learner_step_matches_optax_by_update(monkeypatch):
    """Each minibatch is the whole batch, one epoch (the permutation only
    reorders a mean), with clip_by_global_norm engaged.  A learner on
    torch's clip_grad_norm_ misses the clipped norm, and one with no clip
    misses the updates."""
    from ray_tpu_torch.rllib import learner as learner_mod

    _learner_against_optax()
    for wrong in (_torch_clip, lambda grads, max_norm: list(grads)):
        monkeypatch.setattr(learner_mod, "clip_by_global_norm", wrong)
        with pytest.raises(AssertionError):
            _learner_against_optax()


# -------------------------------------------------------------- V-trace

def _vtrace_fragment(rng, obs_dim, T=6, B=3):
    obs = (rng.integers(0, 256, size=(T, B) + PIXEL).astype(np.uint8)
           if obs_dim == PIXEL
           else rng.normal(size=(T, B, obs_dim)).astype(np.float32))
    boot = (_pixels(rng, B) if obs_dim == PIXEL
            else rng.normal(size=(B, obs_dim)).astype(np.float32))
    term = np.zeros((T, B), np.bool_)
    trunc = np.zeros((T, B), np.bool_)
    term[2, 0] = term[4, 2] = True
    trunc[3, 1] = True
    return SampleBatch({
        SampleBatch.OBS: obs,
        SampleBatch.ACTIONS: rng.integers(0, 4, (T, B)).astype(np.int32),
        SampleBatch.ACTION_LOGP: rng.uniform(-2.0, -0.8, (T, B)).astype(
            np.float32),
        SampleBatch.REWARDS: rng.normal(size=(T, B)).astype(np.float32),
        SampleBatch.TERMINATEDS: term, SampleBatch.TRUNCATEDS: trunc,
        "bootstrap_obs": boot,
    })


def _capture_grads():
    """An optax transform that leaves the params alone and returns the
    gradients as its state: the reference learner's step then hands out
    its loss's exact gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda updates, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, updates), updates))


def _impala_cfgs(lr, grad_clip):
    cfgs = []
    for cls in (JIMPALAConfig, IMPALAConfig):
        cfg = cls()
        cfg.lr, cfg.grad_clip = lr, grad_clip
        cfgs.append(cfg)
    return cfgs


@pytest.mark.parametrize("obs_dim", [4, PIXEL], ids=["mlp", "nature_cnn"])
def test_vtrace_learner_matches_reference(obs_dim):
    rng = np.random.default_rng(8)
    lr = 5e-3
    jcfg, pcfg = _impala_cfgs(lr, grad_clip=1.0)
    ref = JVTraceLearner(obs_dim, 4, jcfg, HIDDEN, seed=4)
    port = _VTraceLearner(obs_dim, 4, pcfg, HIDDEN, seed=4, device="cpu")
    port.set_state(_np(ref.get_state()))
    batches = [_vtrace_fragment(rng, obs_dim) for _ in range(3)]

    # Loss and every gradient at the shared weights.
    grab = JVTraceLearner(obs_dim, 4, jcfg, HIDDEN, seed=4)
    grab.tx = _capture_grads()
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    _, jgrads, jmet = grab._step(ref.params, grab.tx.init(ref.params), jb)
    loss, met = port.loss({k: torch.from_numpy(np.asarray(v))
                           for k, v in batches[0].items()})
    np.testing.assert_allclose(loss.item(), float(jmet["total_loss"]),
                               rtol=1e-5)
    for k in jmet:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]),
                                   rtol=1e-5, atol=1e-6)
    grads = convert.actor_critic_variables(_grads(port.model, loss))
    _assert_trees_close(grads, jgrads, rtol=1e-4, atol=1e-6)

    # Three updates, compared by update.
    for batch in batches:
        before = ref.get_weights()
        rm = ref.update(batch)
        pm = port.update(batch)
        np.testing.assert_allclose(pm["total_loss"], rm["total_loss"],
                                   rtol=1e-4)
        _assert_updates_close(before, port.get_weights(), ref.get_weights(),
                              lr)
    assert port.num_updates == ref.num_updates == 3


def test_learner_thread_reads_whole_updates():
    """LearnerThread steps while the driver reads the weights: every read
    must be the weights after some whole number of updates (the step and
    the read hold one lock), never a mix of two."""
    import sys
    import time

    from ray_tpu_torch.rllib import LearnerThread

    rng = np.random.default_rng(9)
    _, pcfg = _impala_cfgs(1e-2, grad_clip=1.0)
    learner = _VTraceLearner(4, 4, pcfg, HIDDEN, seed=1, device="cpu")
    states = [_leaves(learner.get_weights())]

    class Recording(_VTraceLearner):
        def update(self, batch):
            out = _VTraceLearner.update(self, batch)
            states.append(_leaves(self.get_weights()))
            return out

    learner.__class__ = Recording
    thread = LearnerThread(learner, queue_size=64)
    reads = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(40):
            thread.inqueue.put(_vtrace_fragment(rng, 4))
        thread.start()
        deadline = time.monotonic() + 60
        while learner.num_updates < 40 and time.monotonic() < deadline:
            reads.append(_leaves(learner.get_weights()))
    finally:
        sys.setswitchinterval(old)
        thread.stop()
        thread.join(30)
    assert not thread.is_alive()
    thread.check_error()
    assert learner.num_updates == 40 and len(reads) > 10
    for read in reads:
        assert any(all(np.array_equal(a, b) for a, b in zip(read, st))
                   for st in states)


# -------------------------------------------------------------- drivers

def test_ppo_trains_locally_and_takes_the_references_state():
    cfg = (PPOConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=0, num_envs_per_worker=4,
                     rollout_fragment_length=16)
           .training(train_batch_size=64, sgd_minibatch_size=32,
                     num_sgd_iter=2, model_hidden=HIDDEN)
           .resources(device="cpu", rollout_device="cpu"))
    algo = cfg.build()
    try:
        r = algo.train()
        assert r["sampled_rows"] == 64 and np.isfinite(
            r["learner/total_loss"])
        r = algo.train()
        assert r["training_iteration"] == 2 and r["timesteps_total"] == 128
        state = algo.save_to_dict()
        twin = cfg.build()
        twin.restore_from_dict(state)
        for a, b in zip(_leaves(twin.learner.get_weights()),
                        _leaves(algo.learner.get_weights())):
            np.testing.assert_array_equal(a, b)
        # The reference learner's state (and its weights on the local
        # worker) carries into the port's PPO.
        ref = JaxLearner(4, 2, loss_fn=jppo_loss, config={"lr": 1e-3},
                         hidden=HIDDEN, seed=9)
        twin.restore_from_dict({"learner_state": _np(ref.get_state())})
        for a, b in zip(_leaves(twin.workers.local_worker.get_weights()),
                        _leaves(ref.get_weights())):
            np.testing.assert_array_equal(a, b)
        twin.stop()
    finally:
        algo.stop()


def test_ppo_refuses_remote_workers_without_a_runtime_and_model_axes():
    """Remote rollout workers without a runtime handle; a learner mesh
    takes a data axis (a learner group, tests/test_torch_mesh_replicas
    .py trains one) and refuses any other axis above 1, as the
    reference's learner does.  Multi-agent configs and the Tune binding
    no longer wait (tests/test_torch_rllib_multi_agent.py,
    tests/test_torch_rllib_tune.py)."""
    with pytest.raises(ValueError, match="runtime"):
        PPOConfig().resources(device="cpu", rollout_device="cpu").build()
    data = types.SimpleNamespace(shape={"data": 2})
    assert PPOConfig().resources(learner_mesh=data).learner_mesh is data
    with pytest.raises(ValueError, match="data-parallel only"):
        PPOConfig().resources(
            learner_mesh=types.SimpleNamespace(shape={"data": 2,
                                                      "tensor": 2}))


def _local_algo(cfg, device=None):
    return cfg.rollouts(num_rollout_workers=0).resources(
        device=device, rollout_device=device).build()


def _entry_points():
    return {
        "TorchPolicy": lambda **kw: TorchPolicy(4, 2, HIDDEN, **kw),
        "RolloutWorker": lambda **kw: RolloutWorker("CartPole-v1", **kw),
        "TorchLearner": lambda **kw: TorchLearner(
            4, 2, loss_fn=ppo_loss, config={}, hidden=HIDDEN, **kw),
        "_VTraceLearner": lambda **kw: _VTraceLearner(
            4, 2, IMPALAConfig(), HIDDEN, 0, **kw),
        "PPO": lambda **kw: _local_algo(PPOConfig(), **kw),
        "TorchPolicy(continuous)": lambda **kw: TorchPolicy(
            3, 0, HIDDEN, action_dim=1, **kw),
        "SquashedGaussianRolloutPolicy": lambda **kw:
        SquashedGaussianRolloutPolicy(3, 1, HIDDEN, **kw),
        "DeterministicNoiseRolloutPolicy": lambda **kw:
        DeterministicNoiseRolloutPolicy(3, 1, HIDDEN, **kw),
        "RecurrentTorchPolicy": lambda **kw: RecurrentTorchPolicy(
            3, 3, (8,), 8, **kw),
        "TorchLearner(lstm)": lambda **kw: TorchLearner(
            3, 3, loss_fn=ppo_loss, config={}, hidden=(8,), model="lstm",
            lstm_size=8, **kw),
        "_VTraceLearner(lstm)": lambda **kw: _VTraceLearner(
            3, 3, IMPALAConfig().training(use_lstm=True, lstm_size=8),
            (8,), 0, **kw),
        "_QLearner": lambda **kw: _QLearner(4, 2, DQNConfig(), HIDDEN, 0,
                                            **kw),
        "_SACLearner": lambda **kw: _SACLearner(3, 1, SACConfig(), -2.0,
                                                2.0, 0, **kw),
        "_TD3Learner": lambda **kw: _TD3Learner(3, 1, TD3Config(), -2.0,
                                                2.0, 0, **kw),
        "A2C": lambda **kw: _local_algo(A2CConfig(), **kw),
        "DQN": lambda **kw: _local_algo(DQNConfig(), **kw),
        "SAC": lambda **kw: _local_algo(
            SACConfig().environment("Pendulum-v1"), **kw),
        "TD3": lambda **kw: _local_algo(
            TD3Config().environment("Pendulum-v1"), **kw),
        "BC": lambda **kw: BC(4, 2, **kw),
        "MARWIL": lambda **kw: MARWIL(4, 2, **kw),
        "CQL": lambda **kw: CQL(4, 2, **kw),
        "fit_fqe": lambda **kw: fit_fqe(_fqe_batch(), lambda o: np.full(
            (len(o), 2), 0.5), 2, iterations=1, **kw),
        "MultiAgentRolloutWorker": lambda **kw: MultiAgentRolloutWorker(
            "coop-match", num_envs=2, hidden=HIDDEN, **kw),
        "PPO(multi-agent)": lambda **kw: _local_algo(
            PPOConfig().environment("coop-match").multi_agent(
                policies=["a0", "a1"]), **kw),
        "QMix": lambda **kw: QMixConfig().resources(**kw).build(),
        "VDN": lambda **kw: VDNConfig().resources(**kw).build(),
        "PolicyServer": lambda **kw: PolicyServer(4, 2, **kw),
    }


def _fqe_batch():
    return SampleBatch({
        "obs": np.zeros((4, 3), np.float32),
        "actions": np.zeros(4, np.int64),
        "rewards": np.ones(4, np.float32),
        "terminateds": np.array([0, 1, 0, 1], bool),
        "truncateds": np.zeros(4, bool)})


@pytest.mark.parametrize("name", list(_entry_points()))
def test_entry_points_need_a_card_unless_given_the_cpu(name):
    make = _entry_points()[name]
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    obj = make(device="cpu")
    if hasattr(obj, "stop"):
        obj.stop()


def test_a_learner_mesh_is_data_parallel_only():
    """A learner with data above 1 is built on each rank of a process
    group (a DeviceMesh; tests/test_torch_mesh_replicas.py runs them);
    any other axis above 1 raises, as in the reference; a one-device
    mesh is one device."""
    data = types.SimpleNamespace(shape={"data": 2})
    model = types.SimpleNamespace(shape={"data": 2, "fsdp": 2})
    for make in (lambda mesh: TorchLearner(4, 2, loss_fn=ppo_loss,
                                           config={}, mesh=mesh,
                                           device="cpu"),
                 lambda mesh: _VTraceLearner(4, 2, IMPALAConfig(), HIDDEN,
                                             0, mesh=mesh, device="cpu")):
        with pytest.raises(TypeError, match="DeviceMesh"):
            make(data)
        with pytest.raises(ValueError, match="data-parallel only"):
            make(model)
        make(types.SimpleNamespace(shape={"data": 1}))
    with pytest.raises(ValueError, match="data-parallel only"):
        PPOConfig().resources(learner_mesh=model)
