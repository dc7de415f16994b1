"""The port's multi-agent RL (ray_tpu_torch/rllib/: multi_agent.py,
PPO's multi-agent branch, qmix.py, policy_server.py) against the
reference's (ray_tpu/rllib/), on the CPU at small widths:

- `CooperativeMatchEnv` and `TwoStepGameEnv` give the reference's
  episodes for the same seed and actions; the multi-agent worker routes
  each agent's rows to its policy as the reference's does (the same
  observations, columns, dtypes, counts and metrics);
- one multi-agent PPO iteration on the same rows from the same weights:
  every per-policy learner metric within 1e-5 relative + 1e-6, every
  weight by update at 0.05 * lr, and the whole policy map broadcast to
  the workers;
- QMIX's and VDN's TD loss (1e-5) and gradients (1e-5 relative +
  1e-6) and one update (0.05 * lr) against the reference's jitted step; one `train()` call from
  shared weights (the same replay, td_loss within 1e-4 relative);
  `evaluate_greedy` from shared weights equal; the targets move only at
  their sync (an alias, the reference's idiom, fails that check);
- the policy server's HTTP round trip into a PPO learner update;
- the gates with the port: both PPO policies past 12 on coop-match
  within 12 iterations, QMIX and VDN at the two-step game's optimum 8
  within 20 train() calls.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib import multi_agent as jma
from ray_tpu.rllib import qmix as jqmix
from ray_tpu.rllib.ppo import PPOConfig as JPPOConfig
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import (MultiAgentBatch, MultiAgentRolloutWorker,
                                 PolicyClient, PolicyServer, PPOConfig,
                                 QMixConfig, SampleBatch, TorchLearner,
                                 VDNConfig, ppo_loss)
from ray_tpu_torch.rllib import multi_agent as pma
from ray_tpu_torch.rllib import qmix as pqmix
from tests.test_torch_rllib import _capture_grads, _leaves, _np

torch.set_num_threads(1)

HIDDEN = (32, 32)
RTOL = 1e-5


def _split(aid):
    return {"a0": "p0", "a1": "p1"}[aid]


# ------------------------------------------------------------------ envs

@pytest.mark.parametrize("name", ["coop-match", "two-step-game"])
def test_envs_give_the_references_episodes(name):
    ref = jma.make_multi_agent_env(name, 5, seed=3)
    port = pma.make_multi_agent_env(name, 5, seed=3)
    assert (port.agent_ids, port.observation_dims,
            port.num_actions_by_agent) == (
        ref.agent_ids, ref.observation_dims, ref.num_actions_by_agent)
    ro, po = ref.reset_all(3), port.reset_all(3)
    rng = np.random.default_rng(0)
    n_act = port.num_actions_by_agent["a0"]
    for _ in range(40):
        for a in ref.agent_ids:
            np.testing.assert_array_equal(po[a], ro[a])
        acts = {a: rng.integers(0, n_act, 5) for a in ref.agent_ids}
        (ro, rr, rt, rtr), (po, pr, pt, ptr) = ref.step(acts), \
            port.step(acts)
        for a in ref.agent_ids:
            np.testing.assert_array_equal(pr[a], rr[a])
        np.testing.assert_array_equal(pt, rt)
        np.testing.assert_array_equal(ptr, rtr)
    rets = ref.drain_episode_metrics()
    assert rets[1] and port.drain_episode_metrics() == rets


def test_multi_agent_env_contract():
    env = pma.CooperativeMatchEnv(num_envs=3, seed=0)
    obs = env.reset_all(0)
    assert set(obs) == {"a0", "a1"} and obs["a0"].shape == (3, 4)
    acts = {a: np.argmax(obs[a], axis=1) for a in env.agent_ids}
    _, rew, term, _ = env.step(acts)
    np.testing.assert_allclose(rew["a0"], 1.5)
    np.testing.assert_allclose(rew["a1"], 1.5)
    assert not term.any()


@pytest.mark.parametrize("mapping", ["shared", "split"])
def test_rollout_routes_rows_per_policy_as_the_reference(mapping):
    fn = (lambda aid: "shared") if mapping == "shared" else _split
    pids = ["shared"] if mapping == "shared" else ["p0", "p1"]
    kw = dict(num_envs=4, rollout_fragment_length=8, hidden=HIDDEN, seed=2,
              policies=dict.fromkeys(pids), policy_mapping_fn=fn)
    ref = jma.MultiAgentRolloutWorker("coop-match", **kw)
    port = MultiAgentRolloutWorker("coop-match", device="cpu", **kw)
    port.set_weights(ref.get_weights())
    for a, b in zip(_leaves(port.get_weights()), _leaves(ref.get_weights())):
        np.testing.assert_array_equal(a, b)
    rb, rm = ref.sample()
    pb, pm = port.sample()
    assert isinstance(pb, MultiAgentBatch) and pb.count == rb.count == 32
    assert set(pb.policy_batches) == set(rb.policy_batches) == set(pids)
    for pid in pids:
        got, want = pb.policy_batches[pid], rb.policy_batches[pid]
        assert got.count == want.count == 32 * (2 if mapping == "shared"
                                                else 1)
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
            {k: (v.shape, v.dtype) for k, v in want.items()}
        # The targets, so the observations, follow the env's own draws.
        np.testing.assert_array_equal(got["obs"], want["obs"])
    assert set(pm) == set(rm) and set(pm["per_agent_returns"]) == {"a0",
                                                                   "a1"}
    assert pm["env_steps"] == rm["env_steps"] == 32


def test_rollout_refuses_undeclared_policies():
    with pytest.raises(ValueError, match="undeclared policies"):
        MultiAgentRolloutWorker("coop-match", num_envs=2, device="cpu",
                                policies={"p0": None},
                                policy_mapping_fn=_split)


# ------------------------------------------------------ multi-agent PPO

def _ma_ppo(cls, device=None):
    cfg = (cls().environment("coop-match")
           .rollouts(num_rollout_workers=0, num_envs_per_worker=8,
                     rollout_fragment_length=16)
           .multi_agent(policies=["p0", "p1"], policy_mapping_fn=_split)
           .training(train_batch_size=128, sgd_minibatch_size=128,
                     num_sgd_iter=1, lr=1e-2, model_hidden=HIDDEN,
                     vf_clip_param=10.0)
           .debugging(seed=5))
    if device:
        cfg = cfg.resources(device=device, rollout_device=device)
    return cfg.build()


def test_multi_agent_ppo_iteration_matches_the_reference():
    """The same rows (the reference worker's fragment, handed to both)
    and the same weights: one iteration each, one minibatch of the whole
    batch per policy."""
    ref, port = _ma_ppo(JPPOConfig), _ma_ppo(PPOConfig, "cpu")
    try:
        assert set(port.learners) == set(ref.learners) == {"p0", "p1"}
        state = _np(ref.save_to_dict())
        port.restore_from_dict(state)
        rows = ref.workers.sample_sync()
        ref.workers.sample_sync = port.workers.sample_sync = lambda: rows
        before = {pid: _leaves(ln.get_weights())
                  for pid, ln in ref.learners.items()}
        rr, pr = ref.train(), port.train()
        keys = {k for k in rr if k.startswith(("learner/",
                                               "policy_reward_mean/"))}
        assert keys and keys == {k for k in pr if k.startswith(
            ("learner/", "policy_reward_mean/"))}
        assert {k.split("/")[1] for k in keys if k.startswith("learner/")} \
            == {"p0", "p1"}
        for k in keys:
            assert abs(pr[k] - rr[k]) <= 1e-5 * abs(rr[k]) + 1e-6, (
                k, pr[k], rr[k])
        assert pr["sampled_rows"] == rr["sampled_rows"] == 128
        for pid, ln in port.learners.items():
            for pb, pa, rb, ra in zip(before[pid], _leaves(ln.get_weights()),
                                      before[pid],
                                      _leaves(ref.learners[pid]
                                              .get_weights())):
                np.testing.assert_allclose(pa - pb, ra - rb, rtol=0,
                                           atol=0.05 * 1e-2)
            # The whole map reached the local worker.
            for a, b in zip(_leaves(port.workers.local_worker
                                    .get_weights()[pid]),
                            _leaves(ln.get_weights())):
                np.testing.assert_array_equal(a, b)
    finally:
        ref.stop()
        port.stop()


def test_multi_agent_ppo_both_policies_improve():
    """The reference's gate (tests/test_rllib_multi_agent.py) with the
    port: 16 envs x 32, batch 1024, minibatch 256, 6 SGD iterations, lr
    5e-3, seed 7; both policies reach 12 within 12 iterations (random
    play ~4.5, the optimum 24)."""
    algo = (PPOConfig().environment("coop-match")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=16,
                      rollout_fragment_length=32)
            .multi_agent(policies=["p0", "p1"], policy_mapping_fn=_split)
            .training(train_batch_size=1024, sgd_minibatch_size=256,
                      num_sgd_iter=6, lr=5e-3, entropy_coeff=0.003)
            .resources(device="cpu", rollout_device="cpu")
            .debugging(seed=7).build())
    try:
        first = last = None
        for _ in range(12):
            r = algo.train()
            last = (r["policy_reward_mean/p0"], r["policy_reward_mean/p1"])
            first = first or last
            if min(last) >= 12.0:
                break
        assert min(last) >= 12.0, (first, last)
        assert last[0] > first[0] and last[1] > first[1], (first, last)
    finally:
        algo.stop()


# ---------------------------------------------------------------- QMIX

def _qmix_cfgs(mixer, lr=1e-2):
    out = []
    for cls in (jqmix.QMixConfig, QMixConfig):
        cfg = cls()
        cfg.mixer, cfg.lr, cfg.num_envs_per_worker = mixer, lr, 8
        out.append(cfg)
    out[1] = out[1].resources(device="cpu")
    return out


def _qmix_pair(mixer, lr=1e-2, other_target=True):
    """The reference's QMix and the port's on its params (and a target
    of other weights, so the target path is read)."""
    jcfg, pcfg = _qmix_cfgs(mixer, lr)
    ref, port = jcfg.build(), pcfg.build()
    if other_target:
        jcfg2 = _qmix_cfgs(mixer, lr)[0]
        jcfg2.seed = 11
        ref.target_params = jcfg2.build().params
    port.restore_from_dict(_np(ref.save_to_dict()))
    return ref, port


def _transitions(rng, n=64):
    """Replay columns of the two-step game: states s0 / s2A / s2B
    one-hot for both agents, random joint actions, rewards and dones."""
    def states():
        return np.repeat(np.eye(3, dtype=np.float32)[
            rng.integers(0, 3, n)][:, None, :], 2, 1)

    return (states(), rng.integers(0, 2, (n, 2)),
            (4 * rng.normal(size=n)).astype(np.float32), states(),
            (rng.random(n) < 0.5).astype(np.float32))


@pytest.mark.parametrize("mixer", ["qmix", "vdn"])
def test_qmix_td_loss_gradients_and_update_match_the_reference(mixer):
    rng = np.random.default_rng(4)
    lr = 1e-2
    ref, port = _qmix_pair(mixer, lr)
    assert set(convert.qmix_variables(port.model)) == set(ref.params)
    cols = _transitions(rng)
    # Loss and every gradient: the reference's jitted step with an optax
    # transform that hands back the gradients.
    ref.tx = _capture_grads()
    ref._build_fns()
    _, grads, jloss = ref._train_step(ref.params, ref.target_params,
                                      ref.tx.init(ref.params), *cols)
    t = [torch.as_tensor(c) for c in cols]
    loss = port.td_loss(t[0], t[1].long(), t[2], t[3], t[4])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    names = [n for n, _ in port.model.named_parameters()]
    pgrads = torch.autograd.grad(loss, list(port.model.parameters()))
    got = convert.qmix_variables(dict(zip(names, pgrads)))
    assert set(got) == set(grads)
    # Gradients reach ~10 (rewards of 4 sigma): 1e-5 relative + 1e-6.
    for layer in grads:
        for k in grads[layer]:
            np.testing.assert_allclose(got[layer][k],
                                       np.asarray(grads[layer][k]),
                                       rtol=RTOL, atol=1e-6)
    # One update from fresh Adam states on both sides.
    ref2, port2 = _qmix_pair(mixer, lr)
    before = _leaves(ref2.params)
    params, _, jl = ref2._train_step(ref2.params, ref2.target_params,
                                     ref2.opt_state, *cols)
    pl = port2.train_step(*cols)
    np.testing.assert_allclose(float(pl), float(jl), rtol=RTOL)
    for b, pa, ra in zip(before, _leaves(port2.save_to_dict()["params"]),
                         _leaves(params)):
        np.testing.assert_allclose(pa - b, ra - b, rtol=0, atol=0.05 * lr)


@pytest.mark.parametrize("mixer", ["qmix", "vdn"])
def test_one_train_call_and_greedy_evaluation_match_the_reference(mixer):
    """From shared weights the same greedy actions pick the same replay
    (the numpy draws of exploration and sampling are the reference's):
    one train() call's 16 TD steps give td_loss within 1e-4 relative and
    the same epsilon; evaluate_greedy from shared weights is equal."""
    ref, port = _qmix_pair(mixer, lr=5e-3, other_target=False)
    assert port.evaluate_greedy() == ref.evaluate_greedy()
    rr, pr = ref.train(), port.train()
    assert pr["epsilon"] == rr["epsilon"] and pr["episodes_this_iter"] == \
        rr["episodes_this_iter"]
    np.testing.assert_allclose(pr["td_loss"], rr["td_loss"], rtol=1e-4)
    assert port._buf_pos == ref._buf_pos and len(port._buf) == len(ref._buf)
    for a, b in zip(port._buf[-5:], ref._buf[-5:]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    port.restore_from_dict(_np(ref.save_to_dict()))
    assert port.evaluate_greedy() == ref.evaluate_greedy()


def _qmix_target_holds(rng) -> bool:
    _, port = _qmix_pair("qmix", other_target=False)
    before = _leaves(convert.qmix_variables(port.target))
    for _ in range(3):
        port.train_step(*_transitions(rng))
    held = all(np.array_equal(a, b) for a, b in zip(
        before, _leaves(convert.qmix_variables(port.target))))
    port.sync_target()
    synced = all(np.array_equal(a, b) for a, b in zip(
        _leaves(convert.qmix_variables(port.target)),
        _leaves(convert.qmix_variables(port.model))))
    return held and synced


def test_qmix_target_moves_only_at_its_sync(monkeypatch):
    """The reference's target is the params' arrays (a snapshot under
    JAX's immutability); the port updates in place, so it copies at
    setup and at every sync.  The copy holds; an alias fails."""
    assert _qmix_target_holds(np.random.default_rng(5))
    monkeypatch.setattr(pqmix, "frozen_copy", lambda model: model)
    assert not _qmix_target_holds(np.random.default_rng(5))


@pytest.mark.parametrize("cls", [QMixConfig, VDNConfig],
                         ids=["qmix", "vdn"])
def test_qmix_and_vdn_reach_the_optimum(cls):
    """QMixConfig's and VDNConfig's defaults on the two-step game:
    evaluate_greedy reaches 8 (>= 7.9) within 20 train() calls."""
    algo = cls().resources(device="cpu").build()
    best = 0.0
    for _ in range(20):
        algo.train()
        best = algo.evaluate_greedy()
        if best >= 7.9:
            break
    assert best >= 7.9, best
    st = algo.save_to_dict()
    assert st["steps_sampled"] == algo._steps_sampled > 0


def test_qmix_weights_cross_both_ways():
    """The port's params restore into the reference's QMix bit for bit,
    and its greedy evaluation there equals the port's."""
    ref, port = _qmix_pair("qmix")
    port.train_step(*_transitions(np.random.default_rng(6)))
    state = port.save_to_dict()
    ref.restore_from_dict(jax.tree_util.tree_map(np.asarray, state))
    for a, b in zip(_leaves(ref.params), _leaves(state["params"])):
        np.testing.assert_array_equal(a, b)
    assert port.evaluate_greedy() == ref.evaluate_greedy()


# --------------------------------------------------------- policy server

def test_policy_server_external_env_roundtrip():
    server = PolicyServer(4, 2, seed=0, device="cpu")
    try:
        client = PolicyClient(server.address)
        rng = np.random.default_rng(0)
        for _ in range(3):
            eid = client.start_episode()
            obs = rng.normal(size=4)
            for _t in range(10):
                a = client.get_action(eid, obs)
                assert a in (0, 1)
                client.log_returns(eid, 1.0 if a == 0 else 0.0)
                obs = rng.normal(size=4)
            client.end_episode(eid, obs)
        batch, returns = server.to_sample_batch(min_rows=30)
        assert batch.count == 30 and len(returns) == 3
        assert set(batch) >= {"obs", "actions", "action_logp",
                              "advantages", "value_targets"}
        # The value targets are GAE's over each episode, nothing past it.
        assert batch["value_targets"].dtype == np.float32
        learner = TorchLearner(4, 2, loss_fn=ppo_loss, device="cpu",
                               config={"lr": 1e-3, "num_sgd_iter": 2,
                                       "sgd_minibatch_size": 16})
        assert "total_loss" in learner.update(batch)
        server.set_weights(learner.get_weights())
        for a, b in zip(_leaves(server.get_weights()),
                        _leaves(learner.get_weights())):
            np.testing.assert_array_equal(a, b)
        assert server.to_sample_batch(min_rows=1) is None  # drained
        with pytest.raises(Exception, match="400"):
            client.get_action("no-such-episode", np.zeros(4))
    finally:
        server.stop()


def test_multi_agent_batch_concat():
    rng = np.random.default_rng(7)

    def mb(n):
        return MultiAgentBatch({"p0": SampleBatch(
            {"obs": rng.normal(size=(n, 2)).astype(np.float32)})}, n)

    out = MultiAgentBatch.concat_samples([mb(3), mb(5)])
    assert out.count == 8 and out.policy_batches["p0"].count == 8
