"""The port's continuous-action RL, A2C, exploration and connectors
(ray_tpu_torch/rllib/) against the reference's (ray_tpu/rllib/), on the
CPU at small widths:

- Pendulum-v1 gives the reference's episodes bit for bit from the same
  seed and actions;
- `GaussianActorCritic` gives flax's mean, log_std and value within 1e-5
  on the same weights (carried by `convert`, bit for bit both ways);
  `gaussian_logp` equals the reference's;
- `ppo_loss_continuous` and `a2c_loss` with every gradient against
  `jax.value_and_grad` (1e-5); three learner updates of each against
  `JaxLearner`'s, by update at 0.05 * lr, and a learner state carried
  both ways;
- the Gaussian policy: greedy actions (the clipped mean), unclipped
  draws and the log-probs of its own draws; rollout layouts and the
  uniform warm-up's actions equal to the reference worker's;
- schedules, EpsilonGreedy, GaussianNoise, OrnsteinUhlenbeckNoise, Random
  and every connector equal to the reference's for the same seed;
- PPO on Pendulum-v1 and A2C on CartPole-v1 train with device="cpu";
- per-dimension action bounds ((-1, -2) / (1, 2) on a registered
  2-dimension env): the greedy and sampled actions of the three
  continuous policies (draws rebuilt from the port's generator and the
  reference's formula, 1e-5), the uniform warm-up of the rollout
  worker exactly, and one SAC and two TD3 updates with the reference's
  noise, by update at 0.05 * lr.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import connectors as jconn
from ray_tpu.rllib import env as jenv
from ray_tpu.rllib import exploration as jexp
from ray_tpu.rllib.a2c import a2c_loss as ja2c_loss
from ray_tpu.rllib.learner import JaxLearner
from ray_tpu.rllib.learner import ppo_loss_continuous as jppo_continuous
from ray_tpu.rllib.models import gaussian_logp as jgaussian_logp
from ray_tpu.rllib.models import make_continuous_model as jmake_continuous
from ray_tpu.rllib.models import make_model as jmake_model
from ray_tpu.rllib.policy import JaxPolicy
from ray_tpu.rllib.models import make_deterministic_actor as jmake_det
from ray_tpu.rllib.models import make_squashed_actor as jmake_squashed
from ray_tpu.rllib.policy import (DeterministicNoiseRolloutPolicy as
                                  JDeterministicPolicy,
                                  SquashedGaussianRolloutPolicy as
                                  JSquashedPolicy)
from ray_tpu.rllib.rollout_worker import RolloutWorker as JRolloutWorker
from ray_tpu.rllib.sac import SACConfig as JSACConfig
from ray_tpu.rllib.sac import _SACLearner as JSACLearner
from ray_tpu.rllib.td3 import TD3Config as JTD3Config
from ray_tpu.rllib.td3 import _TD3Learner as JTD3Learner
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import (A2CConfig, DeterministicNoiseRolloutPolicy,
                                 PPOConfig, RolloutWorker, SACConfig,
                                 SampleBatch, SquashedGaussianRolloutPolicy,
                                 TD3Config, TorchLearner, TorchPolicy,
                                 a2c_loss, gaussian_logp,
                                 make_continuous_model, make_model,
                                 ppo_loss_continuous)
from ray_tpu_torch.rllib.sac import _SACLearner
from ray_tpu_torch.rllib.td3 import _TD3Learner
from ray_tpu_torch.rllib import connectors as pconn
from ray_tpu_torch.rllib import env as penv
from ray_tpu_torch.rllib import exploration as pexp
from tests.test_torch_rllib import (PPO_CFG, _assert_trees_close, _grads,
                                    _leaves, _np, _ppo_batch, _tensors)

torch.set_num_threads(1)

HIDDEN = (32, 32)
RTOL = 1e-5


def _gaussian(seed=0, obs_dim=3, action_dim=2):
    """The reference's Gaussian actor-critic weights and apply, and the
    port's model on them."""
    init, apply = jmake_continuous(obs_dim, action_dim, HIDDEN)
    variables = _np(init(jax.random.key(seed)))
    m = make_continuous_model(obs_dim, action_dim, HIDDEN, device="cpu")
    m.load_state_dict(convert.actor_critic_state_dict(variables, m))
    return variables, apply, m


def _continuous_batch(rng, n=64, obs_dim=3, action_dim=2):
    return SampleBatch({
        SampleBatch.OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        SampleBatch.ACTIONS: rng.normal(size=(n, action_dim)).astype(
            np.float32),
        SampleBatch.ACTION_LOGP: rng.uniform(-3.0, -1.0, n).astype(
            np.float32),
        SampleBatch.ADVANTAGES: rng.normal(size=n).astype(np.float32),
        SampleBatch.VALUE_TARGETS: (3 * rng.normal(size=n)).astype(
            np.float32),
    })


# ------------------------------------------------------------------ env

def test_pendulum_gives_the_references_episodes():
    ref = jenv.make_vector_env("Pendulum-v1", 5, seed=4)
    port = penv.make_vector_env("Pendulum-v1", 5, seed=4)
    np.testing.assert_array_equal(ref.reset_all(4), port.reset_all(4))
    rng = np.random.default_rng(0)
    for _ in range(450):              # past two 200-step truncations
        a = rng.uniform(-3.0, 3.0, size=(5, 1)).astype(np.float32)
        for x, y in zip(ref.step(a), port.step(a)):
            np.testing.assert_array_equal(x, y)
    rets = ref.drain_episode_metrics()
    assert rets[0] and rets == port.drain_episode_metrics()
    assert (port.action_dim, port.num_actions, port.action_low,
            port.action_high) == (1, 0, -2.0, 2.0)


# --------------------------------------------------------------- models

def test_gaussian_actor_critic_matches_flax():
    rng = np.random.default_rng(1)
    variables, apply, m = _gaussian(seed=3)
    # A non-zero log_std, so the free parameter is carried across.
    variables["params"]["log_std"] = np.asarray([0.3, -0.7], np.float32)
    m.load_state_dict(convert.actor_critic_state_dict(variables, m))
    x = rng.normal(size=(9, 3)).astype(np.float32)
    ref = apply(variables, x)
    got = m(torch.from_numpy(x))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=RTOL, atol=1e-6)
    for a, b in zip(_leaves(convert.actor_critic_variables(m)),
                    _leaves(variables)):
        np.testing.assert_array_equal(a, b)
    acts = rng.normal(size=(9, 2)).astype(np.float32)
    mean, log_std, _ = got
    np.testing.assert_allclose(
        gaussian_logp(mean, log_std, torch.from_numpy(acts)).detach().numpy(),
        np.asarray(jgaussian_logp(ref[0], ref[1], acts)), rtol=RTOL)


# --------------------------------------------------------------- losses

def _loss_case(name, rng):
    """(reference loss, apply, variables, port loss, port model, batch,
    cfg) of one loss."""
    if name == "ppo_continuous":
        variables, apply, m = _gaussian(seed=2)
        return (jppo_continuous, apply, variables, ppo_loss_continuous, m,
                _continuous_batch(rng), dict(PPO_CFG, entropy_coeff=0.01))
    init, apply = jmake_model(4, 2, HIDDEN)
    variables = _np(init(jax.random.key(5)))
    m = make_model(4, 2, HIDDEN, device="cpu")
    m.load_state_dict(convert.actor_critic_state_dict(variables, m))
    return (ja2c_loss, apply, variables, a2c_loss, m, _ppo_batch(rng, n=64),
            {"vf_loss_coeff": 0.5, "entropy_coeff": 0.01})


@pytest.mark.parametrize("name", ["ppo_continuous", "a2c"])
def test_loss_and_gradients_match_jax(name):
    rng = np.random.default_rng(2)
    jloss_fn, apply, variables, loss_fn, m, mb, cfg = _loss_case(name, rng)
    (jloss, jmet), jgrads = jax.value_and_grad(
        functools.partial(jloss_fn, apply), has_aux=True)(
            variables, {k: jnp.asarray(v) for k, v in mb.items()}, cfg)
    loss, met = loss_fn(m, _tensors(mb), cfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    for k in jmet:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]),
                                   rtol=RTOL, atol=1e-6)
    grads = convert.actor_critic_variables(_grads(m, loss))
    _assert_trees_close(grads, jgrads, rtol=RTOL, atol=1e-7)


def _learners(name, lr, seed=3):
    """A reference JaxLearner and the port's TorchLearner on its state."""
    if name == "ppo_continuous":
        cfg = dict(PPO_CFG, lr=lr, grad_clip=0.5, num_sgd_iter=1,
                   sgd_minibatch_size=64)
        args, kw = (3, 0), {"action_dim": 2}
        jloss, loss = jppo_continuous, ppo_loss_continuous
    else:
        cfg = {"lr": lr, "grad_clip": 0.5, "num_sgd_iter": 1,
               "sgd_minibatch_size": 64, "vf_loss_coeff": 0.5,
               "entropy_coeff": 0.01}
        args, kw = (4, 2), {}
        jloss, loss = ja2c_loss, a2c_loss
    ref = JaxLearner(*args, loss_fn=jloss, config=cfg, hidden=HIDDEN,
                     seed=seed, **kw)
    port = TorchLearner(*args, loss_fn=loss, config=cfg, hidden=HIDDEN,
                        seed=seed, device="cpu", **kw)
    port.set_state(_np(ref.get_state()))
    return ref, port


_OPTAX = {"ScaleByAdamState": optax.ScaleByAdamState,
          "EmptyState": optax.EmptyState,
          "ScaleByScheduleState": optax.ScaleByScheduleState}


def as_optax(tree):
    """The port's state with its namedtuples (optax's names, no optax
    import) as optax's own classes, as a reference checkpoint restore
    hands them to the reference's jitted step."""
    if isinstance(tree, dict):
        return {k: as_optax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_optax(v) for v in tree]
    if isinstance(tree, tuple):
        items = [as_optax(v) for v in tree]
        cls = _OPTAX.get(type(tree).__name__)
        return cls(*items) if cls else tuple(items)
    return tree


def _batch_for(name, rng):
    return (_continuous_batch(rng) if name == "ppo_continuous"
            else _ppo_batch(rng, n=64))


def _step_both(ref, port, batch, lr):
    before_r, before_p = ref.get_weights(), port.get_weights()
    rm, pm = ref.update(batch), port.update(batch)
    np.testing.assert_allclose(pm["total_loss"], rm["total_loss"],
                               rtol=RTOL)
    for pb, pa, rb, ra in zip(_leaves(before_p), _leaves(port.get_weights()),
                              _leaves(before_r), _leaves(ref.get_weights())):
        np.testing.assert_allclose(pa - pb, ra - rb, rtol=0, atol=0.05 * lr)


@pytest.mark.parametrize("name", ["ppo_continuous", "a2c"])
def test_learner_updates_match_jax_by_update(name):
    """Three updates, each one minibatch of the whole batch (one epoch),
    with the global-norm clip engaged on the later ones."""
    rng = np.random.default_rng(3)
    lr = 1e-2
    ref, port = _learners(name, lr)
    for step in range(3):
        batch = _batch_for(name, rng)
        batch[SampleBatch.ADVANTAGES] *= 1 + 3 * step
        _step_both(ref, port, batch, lr)
    assert int(port.get_state()["opt_state"][1][0].count) == 3


@pytest.mark.parametrize("name", ["ppo_continuous", "a2c"])
def test_learner_state_crosses_both_ways(name):
    """The port's state restored into the reference's learner (and back):
    the same weights, bit for bit, and the next update agrees."""
    rng = np.random.default_rng(4)
    lr = 1e-2
    ref, port = _learners(name, lr)
    _step_both(ref, port, _batch_for(name, rng), lr)
    ref2, _ = _learners(name, lr, seed=11)
    ref2.set_state(as_optax(port.get_state()))
    for a, b in zip(_leaves(ref2.get_weights()), _leaves(port.get_weights())):
        np.testing.assert_array_equal(a, b)
    _step_both(ref2, port, _batch_for(name, rng), lr)
    _, port2 = _learners(name, lr, seed=12)
    port2.set_state(_np(ref2.get_state()))
    for a, b in zip(_leaves(ref2.get_state()), _leaves(port2.get_state())):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- policy

def test_gaussian_policy_greedy_draws_and_logps():
    rng = np.random.default_rng(5)
    jp = JaxPolicy(3, 0, HIDDEN, seed=0, action_dim=2, action_low=-0.05,
                   action_high=0.05)
    pp = TorchPolicy(3, 0, HIDDEN, seed=0, device="cpu", action_dim=2,
                     action_low=-0.05, action_high=0.05)
    weights = jp.get_weights()
    weights["params"]["log_std"] = np.asarray([0.5, -0.2], np.float32)
    jp.set_weights(weights)
    pp.set_weights(weights)
    x = rng.normal(size=(256, 3)).astype(np.float32)
    ja, _, jv, jmean = jp.compute_actions(x, explore=False)
    pa, plp, pv, pmean = pp.compute_actions(x, explore=False)
    np.testing.assert_allclose(pa, ja, rtol=RTOL, atol=1e-7)
    assert np.abs(pa).max() <= 0.05 and (plp == 0).all()
    np.testing.assert_allclose(pv, jv, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(pmean, jmean, rtol=RTOL, atol=1e-7)
    a, logp, _, mean = pp.compute_actions(x)
    assert a.dtype == np.float32 and a.shape == (256, 2)
    assert np.abs(a).max() > 0.05           # draws are not clipped
    want = np.asarray(jgaussian_logp(jnp.asarray(jmean),
                                     weights["params"]["log_std"], a))
    np.testing.assert_allclose(logp, want, rtol=RTOL)
    # The draw's spread is the policy's std.
    std = (a - mean).std(0)
    np.testing.assert_allclose(std, np.exp([0.5, -0.2]), rtol=0.15)


@pytest.mark.parametrize("postprocess", [True, False])
def test_continuous_rollout_layouts_and_warmup_actions(postprocess):
    """Pendulum-v1 fragments have the reference's columns, shapes and
    dtypes; under the uniform warm-up (the worker's numpy generator) the
    actions, observations and rewards are the reference's exactly."""
    kw = dict(num_envs=4, rollout_fragment_length=8, hidden=HIDDEN, seed=3,
              postprocess=postprocess, random_warmup_steps=10 ** 6)
    ref = JRolloutWorker("Pendulum-v1", **kw)
    port = RolloutWorker("Pendulum-v1", device="cpu", **kw)
    port.set_weights(ref.get_weights())
    for _ in range(2):
        rb, rm = ref.sample()
        pb, pm = port.sample()
        assert {k: (v.shape, v.dtype) for k, v in pb.items()} == \
            {k: (v.shape, v.dtype) for k, v in rb.items()}
        exact = [SampleBatch.ACTIONS, SampleBatch.OBS]
        if not postprocess:
            exact += [SampleBatch.REWARDS, SampleBatch.TRUNCATEDS,
                      "bootstrap_obs"]
        for k in exact:
            np.testing.assert_array_equal(pb[k], rb[k])
        assert pm["total_env_steps"] == rm["total_env_steps"]
        assert pb[SampleBatch.ACTIONS].shape[-1] == 1


# ---------------------------------------------------------- exploration

SCHEDULES = {
    "constant": lambda m: m.ConstantSchedule(0.3),
    "linear": lambda m: m.LinearSchedule(1.0, 0.05, 37),
    "piecewise": lambda m: m.PiecewiseSchedule([(0, 0.0), (10, 1.0),
                                                (25, 0.5)]),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_equal_the_references(name):
    ref, port = SCHEDULES[name](jexp), SCHEDULES[name](pexp)
    for t in range(-2, 60):
        assert port(t) == ref(t)


STRATEGIES = {
    "epsilon_greedy": (lambda m: m.EpsilonGreedy(4, 1.0, 0.1, 30),
                       lambda r: r.integers(0, 4, 16)),
    "gaussian": (lambda m: m.GaussianNoise(-1.0, 1.0, scale=0.4),
                 lambda r: r.uniform(-1, 1, (16, 2)).astype(np.float32)),
    "ornstein_uhlenbeck": (lambda m: m.OrnsteinUhlenbeckNoise(-1.0, 1.0),
                           lambda r: r.uniform(-1, 1, (16, 2))),
    "random_discrete": (lambda m: m.Random(num_actions=3),
                        lambda r: r.integers(0, 3, 16)),
    "random_continuous": (lambda m: m.Random(action_dim=2, low=-2, high=2),
                          lambda r: r.uniform(-2, 2, (16, 2))),
}


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_exploration_draws_equal_the_references(name):
    make, proposal = STRATEGIES[name]
    ref, port = make(jexp), make(pexp)
    rng_r, rng_p = np.random.default_rng(7), np.random.default_rng(7)
    props = np.random.default_rng(8)
    for t in range(0, 60, 3):
        a = proposal(props)
        np.testing.assert_array_equal(port.apply(a, t, rng_p),
                                      ref.apply(a, t, rng_r))


CONNECTORS = {
    "flatten": (lambda m: m.FlattenObs(), (6, 3, 2)),
    "normalize": (lambda m: m.NormalizeObs(clip=3.0), (32, 3)),
    "clip_obs": (lambda m: m.ClipObs(-0.5, 0.5), (8, 3)),
    "clip_actions": (lambda m: m.ClipActions(-1.0, 1.0), (8, 2)),
    "unsquash": (lambda m: m.UnsquashActions(-2.0, 6.0), (8, 2)),
    "pipeline": (lambda m: m.ConnectorPipeline([m.FlattenObs()]).append(
        m.NormalizeObs()), (16, 2, 2)),
}


@pytest.mark.parametrize("name", list(CONNECTORS))
def test_connectors_equal_the_references(name):
    make, shape = CONNECTORS[name]
    ref, port = make(jconn), make(pconn)
    rng = np.random.default_rng(9)
    for _ in range(5):
        x = rng.normal(2.0, 3.0, size=shape)
        np.testing.assert_array_equal(port(x), ref(x))
    if name == "normalize":
        # The filter's state travels: a frozen copy normalizes as the
        # reference's own does.
        frozen_r, frozen_p = jconn.NormalizeObs(update=False), \
            pconn.NormalizeObs(update=False)
        frozen_r.set_state(ref.get_state())
        frozen_p.set_state(port.get_state())
        x = rng.normal(size=shape)
        np.testing.assert_array_equal(frozen_p(x), frozen_r(x))


# -------------------------------------------------------------- drivers

def _local(cfg):
    return cfg.rollouts(num_rollout_workers=0).resources(
        device="cpu", rollout_device="cpu").debugging(seed=0)


def test_ppo_trains_on_pendulum():
    cfg = _local(PPOConfig().environment("Pendulum-v1")).rollouts(
        num_envs_per_worker=4, rollout_fragment_length=16).training(
            train_batch_size=64, sgd_minibatch_size=32, num_sgd_iter=2,
            model_hidden=HIDDEN)
    algo = cfg.build()
    try:
        for _ in range(2):
            r = algo.train()
        assert r["sampled_rows"] == 64
        assert np.isfinite(r["learner/total_loss"])
        batch, _ = algo.workers.local_worker.sample()
        assert batch[SampleBatch.ACTIONS].dtype == np.float32
        assert batch[SampleBatch.ACTIONS].shape == (64, 1)
        # The reference's continuous learner state carries in.
        ref = JaxLearner(3, 0, action_dim=1, loss_fn=jppo_continuous,
                         config={"lr": 1e-3}, hidden=HIDDEN, seed=5)
        algo.restore_from_dict({"learner_state": _np(ref.get_state())})
        for a, b in zip(_leaves(algo.workers.local_worker.get_weights()),
                        _leaves(ref.get_weights())):
            np.testing.assert_array_equal(a, b)
    finally:
        algo.stop()


def test_a2c_trains_one_pass_over_the_batch():
    cfg = _local(A2CConfig()).rollouts(
        num_envs_per_worker=4, rollout_fragment_length=16).training(
            train_batch_size=64, model_hidden=HIDDEN)
    algo = cfg.build()
    try:
        r = algo.train()
        assert r["sampled_rows"] == 64 and np.isfinite(
            r["learner/total_loss"])
        assert algo.learner.opt.count == 1       # one minibatch, one epoch
        assert algo.learner.config["sgd_minibatch_size"] == 64
    finally:
        algo.stop()


# ------------------------------------------------ per-dimension bounds

LOW2 = np.asarray([-1.0, -2.0], np.float32)
HIGH2 = np.asarray([1.0, 2.0], np.float32)


def _box2(base):
    """A 2-dimension continuous env over `base` (either package's
    VectorEnv) with per-dimension bounds (-1, -2) / (1, 2): observations
    N(0, 1) from the env's generator, reward -|a - obs[:, :2]|^2 on the
    clipped action, 20-step episodes."""

    class Box2(base):
        observation_dim, num_actions, action_dim = 3, 0, 2
        action_low, action_high = LOW2, HIGH2

        def __init__(self, num_envs, seed=0):
            super().__init__(num_envs)
            self._rng = np.random.default_rng(seed)
            self._t = np.zeros(num_envs, np.int64)

        def _draw(self):
            self._obs = self._rng.normal(size=(self.num_envs, 3)).astype(
                np.float32)
            return self._obs

        def reset_all(self, seed=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self._t[:] = 0
            return self._draw()

        def step_batch(self, actions):
            a = np.clip(actions, self.action_low, self.action_high)
            rew = -((a - self._obs[:, :2]) ** 2).sum(-1).astype(np.float32)
            self._t += 1
            trunc = self._t >= 20
            self._t[trunc] = 0
            return (self._draw(), rew, np.zeros(self.num_envs, bool),
                    trunc)

    return Box2


jenv.register_env("Box2-v0", _box2(jenv.VectorEnv))
penv.register_env("Box2-v0", _box2(penv.VectorEnv))


def _scaled_head(weights, layer, factor):
    """The weights with one Dense layer's kernel scaled, so the actions
    reach past the bounds."""
    weights["params"][layer]["kernel"] = (
        weights["params"][layer]["kernel"] * factor)
    return weights


def test_gaussian_policy_clips_and_draws_per_dimension():
    rng = np.random.default_rng(11)
    kw = dict(action_dim=2, action_low=LOW2, action_high=HIGH2)
    jp = JaxPolicy(3, 0, HIDDEN, seed=2, **kw)
    pp = TorchPolicy(3, 0, HIDDEN, seed=2, device="cpu", **kw)
    weights = _scaled_head(jp.get_weights(), "Dense_2", 400.0)
    jp.set_weights(weights)
    pp.set_weights(weights)
    x = rng.normal(size=(256, 3)).astype(np.float32)
    ja, _, _, jmean = jp.compute_actions(x, explore=False)
    pa, _, _, pmean = pp.compute_actions(x, explore=False)
    np.testing.assert_allclose(pmean, jmean, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(pa, ja, rtol=RTOL, atol=1e-6)
    # Each dimension is clipped to its own bound, and the means pass both.
    assert (np.abs(pa) <= HIGH2).all()
    assert (np.abs(pa[:, 1]) > 1.0).any() and (np.abs(jmean) > HIGH2).any()
    a, logp, _, mean = pp.compute_actions(x)
    noise = torch.randn((256, 2), generator=torch.Generator().manual_seed(3))
    std = np.exp(weights["params"]["log_std"])
    np.testing.assert_allclose(a, jmean + std * noise.numpy(), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_allclose(
        logp, np.asarray(jgaussian_logp(jnp.asarray(jmean),
                                        weights["params"]["log_std"], a)),
        rtol=RTOL)


@pytest.mark.parametrize("kind", ["squashed", "deterministic"])
def test_offpolicy_policies_scale_per_dimension(kind):
    """Greedy actions equal the reference's; a draw equals the
    reference's formula on the port generator's noise: tanh(mean + std *
    noise) * scale + center, or clip(actor * scale + center + 0.1 *
    scale * noise, low, high), each per dimension."""
    rng = np.random.default_rng(12)
    kw = dict(action_low=LOW2, action_high=HIGH2)
    if kind == "squashed":
        jp, pp = (JSquashedPolicy(3, 2, HIDDEN, seed=4, **kw),
                  SquashedGaussianRolloutPolicy(3, 2, HIDDEN, seed=4,
                                                device="cpu", **kw))
        apply = jmake_squashed(3, 2, HIDDEN)[1]
    else:
        jp, pp = (JDeterministicPolicy(3, 2, HIDDEN, seed=4, **kw),
                  DeterministicNoiseRolloutPolicy(3, 2, HIDDEN, seed=4,
                                                  device="cpu", **kw))
        apply = jmake_det(3, 2, HIDDEN)[1]
    weights = _scaled_head(jp.get_weights(), "Dense_2", 30.0)
    jp.set_weights(weights)
    pp.set_weights(weights)
    x = rng.normal(size=(256, 3)).astype(np.float32)
    # The scaled head's outputs are O(10) sums that cancel: 1e-5 absolute
    # (a few ulps of their terms), 1e-5 relative.
    for got, want in zip(pp.compute_actions(x, explore=False),
                         jp.compute_actions(x, explore=False)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    gen = torch.Generator().manual_seed(5)
    if kind == "deterministic":          # the greedy call drew once too
        torch.randn((256, 2), generator=gen)
    noise = torch.randn((256, 2), generator=gen).numpy()
    a = pp.compute_actions(x)[0]
    scale, center = (HIGH2 - LOW2) / 2, (HIGH2 + LOW2) / 2
    if kind == "squashed":
        mean, log_std = (np.asarray(t) for t in apply(weights, x))
        want = np.tanh(mean + np.exp(log_std) * noise) * scale + center
    else:
        det = np.asarray(apply(weights, x)) * scale + center
        want = np.clip(det + 0.1 * scale * noise, LOW2, HIGH2)
    np.testing.assert_allclose(a, want, rtol=RTOL, atol=1e-5)
    assert (np.abs(a) <= HIGH2).all() and (np.abs(a[:, 1]) > 1.0).any()


@pytest.mark.parametrize("kind", ["squashed_gaussian", "deterministic_noise",
                                  "actor_critic"])
def test_rollout_warmup_draws_within_each_dimensions_bounds(kind):
    kw = dict(num_envs=4, rollout_fragment_length=8, hidden=HIDDEN, seed=6,
              postprocess=False, policy_kind=kind, random_warmup_steps=64)
    ref = JRolloutWorker("Box2-v0", **kw)
    port = RolloutWorker("Box2-v0", device="cpu", **kw)
    port.set_weights(ref.get_weights())
    rb, _ = ref.sample()
    pb, _ = port.sample()
    for k in ("obs", "actions", "rewards", "truncateds"):
        np.testing.assert_array_equal(pb[k], rb[k])
    acts = pb["actions"]
    assert acts.shape == (8, 4, 2)
    assert (acts >= LOW2).all() and (acts <= HIGH2).all()
    assert np.abs(acts[..., 1]).max() > 1.0


def _box2_transitions(rng, n=64):
    return SampleBatch({
        "obs": rng.normal(size=(n, 3)).astype(np.float32),
        "next_obs": rng.normal(size=(n, 3)).astype(np.float32),
        "actions": rng.uniform(LOW2, HIGH2, (n, 2)).astype(np.float32),
        "rewards": rng.normal(size=n).astype(np.float32),
        "dones": rng.random(n) < 0.1})


def _offpolicy_pair(kind, lr=1e-2, seed=3):
    jcfg, pcfg = ((JSACConfig(), SACConfig()) if kind == "sac"
                  else (JTD3Config(), TD3Config()))
    for cfg in (jcfg, pcfg):
        cfg.model_hidden = HIDDEN
        cfg.actor_lr = cfg.critic_lr = lr
        if kind == "sac":
            cfg.alpha_lr = lr
    jcls, pcls = ((JSACLearner, _SACLearner) if kind == "sac"
                  else (JTD3Learner, _TD3Learner))
    ref = jcls(3, 2, jcfg, LOW2, HIGH2, seed)
    port = pcls(3, 2, pcfg, LOW2, HIGH2, seed, device="cpu")
    port.set_state(_np(ref.get_state()))
    return ref, port


@pytest.mark.parametrize("kind", ["sac", "td3"])
def test_offpolicy_updates_match_the_reference_per_dimension(kind):
    """One SAC update, or two TD3 updates (its delayed actor step and
    polyak on the second), with the reference's own noise: metrics
    within 1e-4 relative, every network by update at 0.05 * lr."""
    rng = np.random.default_rng(13)
    lr = 1e-2
    ref, port = _offpolicy_pair(kind, lr)
    key = "sac_state" if kind == "sac" else "td3_state"
    for _ in range(1 if kind == "sac" else 2):
        batch = _box2_transitions(rng)
        if kind == "sac":
            _, k_next, k_pi = jax.random.split(ref.state.rng, 3)
            noise = (np.asarray(jax.random.normal(k_next, (64, 2))),
                     np.asarray(jax.random.normal(k_pi, (64, 2))))
        else:
            _, k = jax.random.split(ref.state.rng)
            noise = np.asarray(jax.random.normal(k, (64, 2)))
        r0, p0 = _leaves(ref.get_state()[key]), _leaves(
            port.get_state()[key])
        rm, pm = ref.update(batch), port.update(batch, noise=noise)
        assert set(pm) == set(rm)
        for k in rm:
            np.testing.assert_allclose(pm[k], rm[k], rtol=1e-4, atol=1e-6)
        r1, p1 = _leaves(ref.get_state()[key]), _leaves(
            port.get_state()[key])
        assert len(p1) == len(r1)
        for a0, a1, b0, b1 in zip(p0, p1, r0, r1):
            np.testing.assert_allclose(a1 - a0, b1 - b0, rtol=0,
                                       atol=0.05 * lr)
