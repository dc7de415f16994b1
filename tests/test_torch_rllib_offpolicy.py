"""The port's off-policy RL (ray_tpu_torch/rllib/: DQN, SAC, TD3, the
replay buffers) against the reference's (ray_tpu/rllib/), on the CPU at
small widths (hidden (32, 32), batch <= 64):

- SAC's squashed-Gaussian actor, TD3's deterministic actor and the Q
  network give flax's outputs within 1e-5 on the same weights; the
  squashed sample and its log-prob equal the reference's for the same
  noise;
- the DQN loss (double and single Q) and its gradients against the
  reference's; three updates by update at 0.05 * lr, the target
  untouched until its sync (an aliased target, the reference's own
  idiom, fails that check in the port);
- one SAC update with the reference's noise (its key chain split three
  ways), every network by update at 0.05 * lr; alpha after three
  updates; the targets exactly the polyak of the online nets;
- TD3 over two policy_delay periods with the reference's smoothing
  noise: the actor and all three targets move only on the delayed step;
- every learner's `get_state()` restored by the other package, both
  ways, bit for bit, and the next update agrees;
- `_to_transitions`, the SAC / TD3 rollout layouts, the greedy actions
  of both behaviour policies, and the uniform and prioritized replay
  buffers equal to the reference's;
- DQN, SAC and TD3 train with device="cpu"; SAC's squashed policy,
  IMPALA with use_lstm and APPO run on remote rollout actors of a
  `ray_tpu` cluster.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu.rllib import replay_buffer as jreplay
from ray_tpu.rllib.dqn import DQNConfig as JDQNConfig
from ray_tpu.rllib.dqn import _QLearner as JQLearner
from ray_tpu.rllib.dqn import _to_transitions as jto_transitions
from ray_tpu.rllib.models import (make_deterministic_actor, make_q_network,
                                  make_squashed_actor)
from ray_tpu.rllib.policy import (DeterministicNoiseRolloutPolicy as
                                  JDeterministicPolicy,
                                  SquashedGaussianRolloutPolicy as
                                  JSquashedPolicy)
from ray_tpu.rllib.rollout_worker import RolloutWorker as JRolloutWorker
from ray_tpu.rllib.sac import SACConfig as JSACConfig
from ray_tpu.rllib.sac import _SACLearner as JSACLearner
from ray_tpu.rllib.sac import _squashed_sample as jsquashed_sample
from ray_tpu.rllib.td3 import TD3Config as JTD3Config
from ray_tpu.rllib.td3 import _TD3Learner as JTD3Learner
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import (APPOConfig, DeterministicNoiseRolloutPolicy,
                                 DQNConfig, IMPALAConfig, RolloutWorker,
                                 SACConfig, SampleBatch,
                                 SquashedGaussianRolloutPolicy, TD3Config,
                                 make_offpolicy_model)
from ray_tpu_torch.rllib import dqn as pdqn
from ray_tpu_torch.rllib import replay_buffer as preplay
from ray_tpu_torch.rllib.dqn import _QLearner, _to_transitions
from ray_tpu_torch.rllib.sac import _SACLearner, squashed_sample
from ray_tpu_torch.rllib.td3 import _TD3Learner
from tests.test_torch_rllib import _capture_grads, _leaves, _np, _tensors
from tests.test_torch_rllib_continuous import as_optax

torch.set_num_threads(1)

HIDDEN = (32, 32)
RTOL = 1e-5
LOW, HIGH = -2.0, 2.0


def _transitions(rng, n=64, obs_dim=3, action_dim=1, discrete=0):
    done = rng.random(n) < 0.2
    return SampleBatch({
        "obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": (rng.integers(0, discrete, n).astype(np.int32)
                    if discrete else
                    rng.uniform(LOW, HIGH, (n, action_dim)).astype(
                        np.float32)),
        "rewards": rng.normal(size=n).astype(np.float32),
        "dones": done,
    })


# --------------------------------------------------------------- models

MODELS = {
    "squashed": (make_squashed_actor, 2),
    "deterministic": (make_deterministic_actor, 2),
    "q": (make_q_network, 2),
}


@pytest.mark.parametrize("kind", list(MODELS))
def test_offpolicy_models_match_flax(kind):
    rng = np.random.default_rng(0)
    make, action_dim = MODELS[kind]
    init, apply = make(3, action_dim, HIDDEN)
    variables = _np(init(jax.random.key(1)))
    m = make_offpolicy_model(kind, 3, action_dim, HIDDEN, device="cpu")
    m.load_state_dict(convert.actor_critic_state_dict(variables, m))
    obs = rng.normal(size=(16, 3)).astype(np.float32)
    args = (obs,)
    if kind == "q":
        args += (rng.uniform(-2, 2, (16, action_dim)).astype(np.float32),)
    want = apply(variables, *args)
    got = m(*(torch.from_numpy(a) for a in args))
    if kind != "squashed":
        want, got = (want,), (got,)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=RTOL, atol=1e-6)
    for a, b in zip(_leaves(convert.actor_critic_variables(m)),
                    _leaves(variables)):
        np.testing.assert_array_equal(a, b)


def test_squashed_sample_and_logp_match_the_reference():
    rng = np.random.default_rng(1)
    init, apply = make_squashed_actor(3, 2, HIDDEN)
    variables = _np(init(jax.random.key(2)))
    m = make_offpolicy_model("squashed", 3, 2, HIDDEN, device="cpu")
    m.load_state_dict(convert.actor_critic_state_dict(variables, m))
    obs = rng.normal(size=(64, 3)).astype(np.float32)
    key = jax.random.key(3)
    want_a, want_logp = jsquashed_sample(apply, variables, obs, key,
                                         jnp.float32(2.0), jnp.float32(0.0))
    noise = np.array(jax.random.normal(key, (64, 2)))
    a, logp = squashed_sample(m, torch.from_numpy(obs),
                              torch.from_numpy(noise), 2.0, 0.0)
    a = a.detach().numpy()
    np.testing.assert_allclose(a, np.asarray(want_a), rtol=RTOL, atol=1e-6)
    # The log-det's log(scale * (1 - t^2) + 1e-6) amplifies a last-bit
    # difference between XLA's and PyTorch's tanh by 2 * scale * |t| /
    # (scale * (1 - t^2) + 1e-6): the tolerance is 1e-5 relative plus
    # two ulps of t so amplified, summed over the action dims.
    t = a / 2.0
    cond = (2 * 2.0 * np.abs(t) / (2.0 * (1 - t ** 2) + 1e-6)).sum(-1)
    err = np.abs(logp.detach().numpy() - np.asarray(want_logp))
    assert (err <= RTOL * np.abs(np.asarray(want_logp))
            + 2 * 2.0 ** -23 * cond + 1e-6).all()


# ------------------------------------------------------------------ DQN

def _dqn_cfgs(lr=1e-2, double_q=True):
    out = []
    for cls in (JDQNConfig, DQNConfig):
        cfg = cls()
        cfg.lr, cfg.grad_clip, cfg.double_q = lr, 1.0, double_q
        out.append(cfg)
    return out


def _dqn_pair(double_q=True, lr=1e-2, seed=2):
    jcfg, pcfg = _dqn_cfgs(lr, double_q)
    ref = JQLearner(4, 2, jcfg, HIDDEN, seed)
    port = _QLearner(4, 2, pcfg, HIDDEN, seed, device="cpu")
    state = _np(ref.get_state())
    # A target other than the params, so the target's role shows.
    state["target_params"] = _np(JQLearner(4, 2, jcfg, HIDDEN,
                                           seed + 50).get_weights())
    ref.set_state(state)
    port.set_state(state)
    return ref, port, jcfg


@pytest.mark.parametrize("double_q", [True, False],
                         ids=["double_q", "single_q"])
def test_dqn_loss_gradients_and_updates_match_the_reference(double_q):
    rng = np.random.default_rng(3)
    lr = 1e-2
    ref, port, jcfg = _dqn_pair(double_q, lr)
    batch = _transitions(rng, obs_dim=4, discrete=2)
    grab = JQLearner(4, 2, jcfg, HIDDEN, 0)
    grab.tx = _capture_grads()
    _, jgrads, jmet = grab._step(ref.params, grab.tx.init(ref.params),
                                 ref.target_params,
                                 {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    loss, met = port.loss(_tensors(batch))
    np.testing.assert_allclose(loss.item(), float(jmet["loss"]), rtol=RTOL)
    for k in ("td_error_mean", "q_mean"):
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=RTOL,
                                   atol=1e-6)
    grads = convert.actor_critic_variables(dict(zip(
        [n for n, _ in port.model.named_parameters()],
        torch.autograd.grad(loss, list(port.model.parameters()),
                            allow_unused=True, materialize_grads=True))))
    for a, b in zip(_leaves(grads), _leaves(jgrads)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)
    for _ in range(3):
        b = _transitions(rng, obs_dim=4, discrete=2)
        w_r, w_p = ref.get_weights(), port.get_weights()
        rm, pm = ref.update(b), port.update(b)
        np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=RTOL)
        for pb, pa, rb, ra in zip(_leaves(w_p), _leaves(port.get_weights()),
                                  _leaves(w_r), _leaves(ref.get_weights())):
            np.testing.assert_allclose(pa - pb, ra - rb, rtol=0,
                                       atol=0.05 * lr)


def _dqn_target_holds(rng) -> bool:
    """Whether the port's target stays put across updates and becomes the
    params at a sync."""
    _, port, _ = _dqn_pair()
    before = _leaves(port.get_state()["target_params"])
    for _ in range(3):
        port.update(_transitions(rng, obs_dim=4, discrete=2))
    held = all(np.array_equal(a, b) for a, b in zip(
        before, _leaves(port.get_state()["target_params"])))
    port.sync_target()
    st = port.get_state()
    synced = all(np.array_equal(a, b) for a, b in zip(
        _leaves(st["target_params"]), _leaves(st["params"])))
    port.update(_transitions(rng, obs_dim=4, discrete=2))
    st2 = port.get_state()
    after_sync = all(np.array_equal(a, b) for a, b in zip(
        _leaves(st["target_params"]), _leaves(st2["target_params"])))
    return held and synced and after_sync


def test_dqn_target_moves_only_at_its_sync(monkeypatch):
    """The reference aliases its target to the params (a snapshot under
    JAX's immutability); the port updates in place, so an alias would
    follow every update.  The port's copy holds; an alias fails."""
    assert _dqn_target_holds(np.random.default_rng(4))
    monkeypatch.setattr(pdqn, "frozen_copy", lambda model: model)
    assert not _dqn_target_holds(np.random.default_rng(4))


# ------------------------------------------------------------------ SAC

def _sac_pair(lr=1e-2, seed=3):
    jcfg, pcfg = JSACConfig(), SACConfig()
    for cfg in (jcfg, pcfg):
        cfg.model_hidden = HIDDEN
        cfg.actor_lr = cfg.critic_lr = cfg.alpha_lr = lr
    ref = JSACLearner(3, 1, jcfg, LOW, HIGH, seed)
    port = _SACLearner(3, 1, pcfg, LOW, HIGH, seed, device="cpu")
    state = _np(ref.get_state())
    # Targets other than the online nets, so polyak has work to do.
    other = _np(JSACLearner(3, 1, jcfg, LOW, HIGH, seed + 50).get_state())
    for name in ("q1_t", "q2_t"):
        state["sac_state"][name] = other["sac_state"][name]
    ref.set_state(state)
    port.set_state(state)
    return ref, port


def _sac_noise(ref, n, action_dim=1):
    _, k_next, k_pi = jax.random.split(ref.state.rng, 3)
    return (np.asarray(jax.random.normal(k_next, (n, action_dim))),
            np.asarray(jax.random.normal(k_pi, (n, action_dim))))


def _nets(state, names):
    return {name: _leaves(state[name]) for name in names}


SAC_NETS = ("actor", "q1", "q2", "q1_t", "q2_t", "log_alpha")


def test_sac_update_matches_the_reference_with_its_noise():
    rng = np.random.default_rng(5)
    lr = 1e-2
    ref, port = _sac_pair(lr)
    for step in range(3):
        batch = _transitions(rng)
        noise = _sac_noise(ref, 64)
        r0 = _nets(ref.get_state()["sac_state"], SAC_NETS)
        p0 = _nets(port.get_state()["sac_state"], SAC_NETS)
        rm = ref.update(batch)
        pm = port.update(batch, noise=noise)
        for k in rm:
            np.testing.assert_allclose(pm[k], rm[k], rtol=1e-4, atol=1e-6)
        r1 = _nets(ref.get_state()["sac_state"], SAC_NETS)
        p1 = _nets(port.get_state()["sac_state"], SAC_NETS)
        for name in SAC_NETS:
            for a0, a1, b0, b1 in zip(p0[name], p1[name], r0[name],
                                      r1[name]):
                np.testing.assert_allclose(a1 - a0, b1 - b0, rtol=0,
                                           atol=0.05 * lr)
        # The targets: exactly the polyak of the updated online nets.
        for t, s in (("q1_t", "q1"), ("q2_t", "q2")):
            for tb, ta, sa in zip(p0[t], p1[t], p1[s]):
                np.testing.assert_allclose(
                    ta, np.float32(0.995) * tb + np.float32(0.005) * sa,
                    rtol=0, atol=1e-7)
    # alpha after three updates (the temperature's own Adam).
    np.testing.assert_allclose(
        np.exp(port.get_state()["sac_state"]["log_alpha"]),
        np.exp(np.asarray(ref.state.log_alpha)), rtol=1e-5)
    assert port.num_updates == ref.num_updates == 3


# ------------------------------------------------------------------ TD3

def _td3_pair(lr=1e-2, seed=4):
    jcfg, pcfg = JTD3Config(), TD3Config()
    for cfg in (jcfg, pcfg):
        cfg.model_hidden = HIDDEN
        cfg.actor_lr = cfg.critic_lr = lr
    ref = JTD3Learner(3, 1, jcfg, LOW, HIGH, seed)
    port = _TD3Learner(3, 1, pcfg, LOW, HIGH, seed, device="cpu")
    state = _np(ref.get_state())
    other = _np(JTD3Learner(3, 1, jcfg, LOW, HIGH, seed + 50).get_state())
    for name in ("actor_t", "q1_t", "q2_t"):
        state["td3_state"][name] = other["td3_state"][name]
    ref.set_state(state)
    port.set_state(state)
    return ref, port


TD3_NETS = ("actor", "actor_t", "q1", "q2", "q1_t", "q2_t")


def _td3_noise(ref, n, action_dim=1):
    _, k = jax.random.split(ref.state.rng)
    return np.asarray(jax.random.normal(k, (n, action_dim)))


def test_td3_delays_its_actor_and_targets():
    rng = np.random.default_rng(6)
    lr = 1e-2
    ref, port = _td3_pair(lr)
    for update in range(1, 5):
        batch = _transitions(rng)
        noise = _td3_noise(ref, 64)
        r0 = _nets(ref.get_state()["td3_state"], TD3_NETS)
        p0 = _nets(port.get_state()["td3_state"], TD3_NETS)
        rm = ref.update(batch)
        pm = port.update(batch, noise=noise)
        assert set(pm) == set(rm)
        for k in rm:
            np.testing.assert_allclose(pm[k], rm[k], rtol=1e-4, atol=1e-6)
        r1 = _nets(ref.get_state()["td3_state"], TD3_NETS)
        p1 = _nets(port.get_state()["td3_state"], TD3_NETS)
        delayed = update % 2 == 0
        assert ("actor_loss" in pm) == delayed
        for name in TD3_NETS:
            moved = any(not np.array_equal(a, b)
                        for a, b in zip(p0[name], p1[name]))
            assert moved == (delayed or name in ("q1", "q2")), (update,
                                                                 name)
            for a0, a1, b0, b1 in zip(p0[name], p1[name], r0[name],
                                      r1[name]):
                np.testing.assert_allclose(a1 - a0, b1 - b0, rtol=0,
                                           atol=0.05 * lr)
    assert port.num_updates == ref.num_updates == 4


# ------------------------------------------------------- state crossing

def _pair(kind):
    return {"dqn": lambda: _dqn_pair()[:2], "sac": _sac_pair,
            "td3": _td3_pair}[kind]()


def _update_pair(kind, ref, port, batch):
    if kind == "sac":
        noise = _sac_noise(ref, len(batch["obs"]))
        return ref.update(batch), port.update(batch, noise=noise)
    if kind == "td3":
        noise = _td3_noise(ref, len(batch["obs"]))
        return ref.update(batch), port.update(batch, noise=noise)
    return ref.update(batch), port.update(batch)


@pytest.mark.parametrize("kind", ["dqn", "sac", "td3"])
def test_learner_state_crosses_both_ways(kind):
    """After an update, the port's state restored into a fresh reference
    learner gives the port's state back bit for bit (the reference's
    into the port likewise, at construction); the next update of the two
    agrees."""
    rng = np.random.default_rng(7)

    def batch():
        return _transitions(rng, obs_dim=4, discrete=2) if kind == "dqn" \
            else _transitions(rng)

    ref, port = _pair(kind)
    _update_pair(kind, ref, port, batch())
    ref2, _ = _pair(kind)
    ref2.set_state(as_optax(port.get_state()))
    ps, rs = port.get_state(), _np(ref2.get_state())
    assert _leaves(ps) and len(_leaves(ps)) == len(_leaves(rs))
    for a, b in zip(_leaves(ps), _leaves(rs)):
        np.testing.assert_array_equal(a, b)
    if kind != "dqn":
        ref2.state = ref2.state._replace(rng=ref.state.rng)
    rm, pm = _update_pair(kind, ref2, port, batch())
    for k in rm:
        np.testing.assert_allclose(pm[k], rm[k], rtol=1e-4, atol=1e-6)


# -------------------------------------------------- transitions, workers

def test_to_transitions_equals_the_references():
    rng = np.random.default_rng(8)
    T, B = 5, 3
    term, trunc = rng.random((T, B)) < 0.3, rng.random((T, B)) < 0.3
    frag = SampleBatch({
        "obs": rng.normal(size=(T, B, 3)).astype(np.float32),
        "actions": rng.normal(size=(T, B, 1)).astype(np.float32),
        "rewards": rng.normal(size=(T, B)).astype(np.float32),
        "terminateds": term, "truncateds": trunc,
        "bootstrap_obs": rng.normal(size=(B, 3)).astype(np.float32)})
    got, want = _to_transitions(frag), jto_transitions(frag)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # Only a termination zeroes the bootstrap.
    np.testing.assert_array_equal(got["dones"], term.reshape(-1))


@pytest.mark.parametrize("kind", ["squashed_gaussian",
                                  "deterministic_noise"])
def test_offpolicy_rollout_layouts_warmup_and_greedy_actions(kind):
    kw = dict(num_envs=4, rollout_fragment_length=8, hidden=HIDDEN, seed=2,
              postprocess=False, policy_kind=kind, random_warmup_steps=40)
    ref = JRolloutWorker("Pendulum-v1", **kw)
    port = RolloutWorker("Pendulum-v1", device="cpu", **kw)
    port.set_weights(ref.get_weights())
    rb, _ = ref.sample()
    pb, _ = port.sample()
    assert {k: (v.shape, v.dtype) for k, v in pb.items()} == \
        {k: (v.shape, v.dtype) for k, v in rb.items()}
    for k in pb:            # 32 steps, all inside the 40-step warm-up
        if k == "action_logits":       # the policy's means, computed
            np.testing.assert_allclose(pb[k], rb[k], rtol=RTOL, atol=1e-6)
        else:
            np.testing.assert_array_equal(pb[k], rb[k])
    np.testing.assert_array_equal(_to_transitions(pb)["obs"],
                                  jto_transitions(rb)["obs"])
    # Past the warm-up the behaviour policy acts; its greedy actions are
    # the reference's.
    pb, _ = port.sample()
    assert np.abs(pb["actions"]).max() <= 2.0
    x = np.random.default_rng(9).normal(size=(16, 3)).astype(np.float32)
    jcls, pcls = ((JSquashedPolicy, SquashedGaussianRolloutPolicy)
                  if kind == "squashed_gaussian"
                  else (JDeterministicPolicy,
                        DeterministicNoiseRolloutPolicy))
    jp = jcls(3, 1, HIDDEN, seed=0, action_low=LOW, action_high=HIGH)
    pp = pcls(3, 1, HIDDEN, seed=0, action_low=LOW, action_high=HIGH,
              device="cpu")
    pp.set_weights(jp.get_weights())
    for a, b in zip(pp.compute_actions(x, explore=False),
                    jp.compute_actions(x, explore=False)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("prioritized", [False, True],
                         ids=["uniform", "prioritized"])
def test_replay_buffers_equal_the_references(prioritized):
    rng = np.random.default_rng(10)
    if prioritized:
        ref = jreplay.PrioritizedReplayBuffer(64, alpha=0.7, seed=3)
        port = preplay.PrioritizedReplayBuffer(64, alpha=0.7, seed=3)
    else:
        ref = jreplay.ReplayBuffer(64, seed=3)
        port = preplay.ReplayBuffer(64, seed=3)
    for i in range(9):                       # 90 rows: the ring wraps
        b = SampleBatch({"x": np.arange(10) + 10 * i,
                         "y": rng.normal(size=(10, 2)).astype(np.float32)})
        ref.add(b)
        port.add(b)
        assert len(ref) == len(port)
        want, got = ref.sample(16), port.sample(16)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        if prioritized:
            idx = want["batch_indexes"][:4]
            prio = rng.uniform(0.1, 5.0, 4)
            ref.update_priorities(idx, prio)
            port.update_priorities(idx, prio)


# -------------------------------------------------------------- drivers

def _local(cfg, **training):
    return (cfg.rollouts(num_rollout_workers=0, num_envs_per_worker=4,
                         rollout_fragment_length=16)
            .training(model_hidden=HIDDEN, learning_starts=64,
                      updates_per_step=4, **training)
            .resources(device="cpu", rollout_device="cpu").debugging(seed=0))


@pytest.mark.parametrize("algo_name", ["dqn", "sac", "td3"])
def test_offpolicy_algorithms_train_on_the_cpu(algo_name):
    cfg = {"dqn": lambda: _local(DQNConfig(), target_update_freq=6),
           "sac": lambda: _local(SACConfig().environment("Pendulum-v1"),
                                 random_warmup_steps=32),
           "td3": lambda: _local(TD3Config().environment("Pendulum-v1"),
                                 random_warmup_steps=32)}[algo_name]()
    algo = cfg.build()
    try:
        r1 = algo.train()
        assert r1["buffer_size"] == 64 and r1["updates_this_iter"] == 4
        r2 = algo.train()
        assert r2["buffer_size"] == 128 and \
            r2["learner_updates_total"] == 8
        losses = [v for k, v in r2.items() if k.startswith("learner/")]
        assert losses and all(np.isfinite(losses))
        # The local worker acts with the learner's weights.
        for a, b in zip(_leaves(algo.workers.local_worker.get_weights()),
                        _leaves(algo.learner.get_weights())):
            np.testing.assert_array_equal(a, b)
        state = algo.save_to_dict()
        twin = cfg.build()
        twin.restore_from_dict(state)
        for a, b in zip(_leaves(twin.learner.get_state()),
                        _leaves(algo.learner.get_state())):
            np.testing.assert_array_equal(a, b)
        twin.stop()
    finally:
        algo.stop()


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu.init(num_cpus=6, object_store_memory=64 << 20)
    yield info
    ray_tpu.shutdown()


def test_remote_rollouts_for_sac_lstm_impala_and_appo(cluster):
    """SAC's squashed-Gaussian policy on remote rollout actors (the
    policy kind plumbed through the worker kwargs, the actor's weights
    broadcast), IMPALA with use_lstm (recurrent fragments with their
    states) and APPO on CartPole-v1."""
    def remote(cfg, **rollouts):
        return (cfg.rollouts(**rollouts)
                .resources(runtime=ray_tpu, device="cpu",
                           rollout_device="cpu").debugging(seed=0))

    sac = remote(SACConfig().environment("Pendulum-v1"),
                 num_rollout_workers=2, num_envs_per_worker=4,
                 rollout_fragment_length=16).training(
        learning_starts=64, updates_per_step=2, model_hidden=HIDDEN).build()
    try:
        r1, r2 = sac.train(), sac.train()
        assert r2["buffer_size"] > r1["buffer_size"] > 0
        assert r2["learner_updates_total"] > 0
    finally:
        sac.stop()
    for cfg in (IMPALAConfig().environment("RepeatPrev-v0").training(
                    use_lstm=True, lstm_size=16, model_hidden=(16,)),
                APPOConfig().environment("CartPole-v1").training(
                    model_hidden=HIDDEN, min_updates_per_step=2)):
        algo = remote(cfg, num_rollout_workers=1, num_envs_per_worker=4,
                      rollout_fragment_length=16).build()
        try:
            r = algo.train()
            assert r["learner_updates_total"] >= cfg.min_updates_per_step
            assert np.isfinite(r["learner/total_loss"])
        finally:
            algo.stop()
