"""The port's RL substrate (ray_tpu_torch/rl/) against the reference's
(ray_tpu/rl/), on the CPU at nano sizes:

- `TrajectoryQueue`: the reference's staleness, backpressure, timeout
  and eviction cases restated, with the Observer's counters;
- `EngineRolloutActor` at gpt nano, greedy, on the reference's weights:
  actions token-exact and log-probs within 1e-5 of the reference actor's,
  the batch's layout and version tags, and an adopt mid-flight (of the
  reference's second weight set) that keeps its lanes and matches the
  reference doing the same;
- `StaleTolerantLearner`: staleness and versions, COMMITTED checkpoints
  that cross both ways (the reference restores the port's save and the
  port the reference's, bit for bit, and the next update agrees by
  update at 0.05 * lr);
- through the reference's runtime (`runtime=ray_tpu`, a local cluster):
  the port's `Podracer` at k=0 with one worker trains on staleness 0
  throughout, and a killed worker is replaced and re-adopts the current
  weights; the port's `IMPALA` consumes fragments from a remote worker.
"""

import time
import types

import jax
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu.rl import EngineRolloutActor as JEngineRolloutActor
from ray_tpu.rl import StaleTolerantLearner as JStaleTolerantLearner
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import convert, gpt
from ray_tpu_torch.rl import (EngineRolloutActor, EnvRolloutActor,
                              PodracerConfig, StaleTolerantLearner,
                              TrajectoryQueue)
from ray_tpu_torch.rllib import IMPALAConfig, SampleBatch
from ray_tpu_torch.util.observe import Observer

torch.set_num_threads(1)

HIDDEN = (8,)
LR = 5e-3
TIMEOUT = 120       # seconds for any one runtime call


class Recorder(Observer):
    """Counts every counter increment, instant event and span by name."""

    def __init__(self):
        self.counts = {}
        self.events = []
        self.spans = []

    def inc(self, name, n=1.0):
        self.counts[name] = self.counts.get(name, 0) + n

    def record(self, plane, kind, **fields):
        self.events.append((plane, kind))

    def begin(self, plane, kind, **fields):
        self.spans.append((plane, kind, fields.get("version")))

    def observe(self, name, value):
        self.counts.setdefault(f"{name}/values", []).append(value)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves(_np(tree))


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu.init(num_cpus=8, object_store_memory=64 << 20)
    yield info
    ray_tpu.shutdown()


# ------------------------------------------------------ trajectory queue

def test_trajectory_queue_staleness_and_backpressure():
    rec = Recorder()
    q = TrajectoryQueue(capacity=2, staleness_bound=1, observer=rec)
    assert q.put("a", version=5, learner_version=5)
    assert q.put("b", version=4, learner_version=5)      # staleness 1: ok
    assert not q.put("c", version=3, learner_version=5)  # staleness 2: drop
    assert not q.put("d", version=5, learner_version=5)  # full: backpressure
    assert q.full and len(q) == 2
    st = q.stats()
    assert (st["accepted"], st["stale_dropped"], st["backpressured"]) == \
        (2, 1, 1)
    assert q.get(learner_version=5) == ("a", 5)
    # "b" went stale while queued once the learner reached 6.
    assert q.get(learner_version=6) is None
    assert q.stats()["stale_dropped"] == 2 and len(q) == 0
    assert rec.counts == {"rl_trajectories_accepted": 2,
                          "rl_trajectories_stale_dropped": 2,
                          "rl_trajectory_backpressure": 1}
    assert rec.events.count(("rl", "stale_drop")) == 2


def test_trajectory_queue_get_timeout_and_evict_stale():
    q = TrajectoryQueue(capacity=4, staleness_bound=0)
    t0 = time.monotonic()
    assert q.get(learner_version=1, timeout=0.05) is None
    assert time.monotonic() - t0 >= 0.04
    for v in (1, 2, 3):
        assert q.put(f"b{v}", version=v, learner_version=3 if v == 3 else v)
    assert q.evict_stale(learner_version=3) == 2
    assert q.get(learner_version=3) == ("b3", 3)
    with pytest.raises(ValueError):
        TrajectoryQueue(capacity=0)
    with pytest.raises(ValueError):
        TrajectoryQueue(staleness_bound=-1)


# ------------------------------------------------------- engine rollouts

def _nano_params(seed):
    jp = jgpt.init_params(jgpt.CONFIGS["nano"], jax.random.key(seed))
    return jp, _np(jp)


def _port_params(tree):
    return convert.params_from_numpy(tree, gpt.CONFIGS["nano"], device="cpu")


PROMPTS = [[1, 2, 3], [1, 2, 4, 9, 11], [5, 6, 7, 8], [1, 2, 3, 30]]


def test_engine_rollouts_match_the_reference():
    jp, npp = _nano_params(7)
    kw = dict(max_lanes=3, temperature=0.0, seed=0)
    ref = JEngineRolloutActor("gpt", "nano", params=jp, **kw)
    port = EngineRolloutActor("gpt", "nano", params=_port_params(npp),
                              device="cpu", **kw)
    rb, rv, _ = ref.rollout(PROMPTS, max_new_tokens=6)
    pb, pv, pm = port.rollout(PROMPTS, max_new_tokens=6)
    assert rv == pv == 0
    np.testing.assert_array_equal(pb["actions"], rb["actions"])
    np.testing.assert_array_equal(pb["valid"], rb["valid"])
    np.testing.assert_allclose(pb["action_logp"], rb["action_logp"],
                               atol=1e-5, rtol=0)
    assert {k: (v.shape, v.dtype) for k, v in pb.items()} == \
        {k: (v.shape, v.dtype) for k, v in rb.items()}
    T, B = pb[SampleBatch.ACTIONS].shape
    assert B == 4 and T == 6 and pm["tokens"] == int(pb["valid"].sum())
    assert pb[SampleBatch.TERMINATEDS].sum(axis=0).tolist() == [1] * 4
    # Adopting the reference's second weight set re-tags the next batch.
    jp2, npp2 = _nano_params(8)
    assert ref.adopt(4, jp2) == port.adopt(4, npp2) == 4
    rb, rv, _ = ref.rollout(PROMPTS, max_new_tokens=4)
    pb, pv, _ = port.rollout(PROMPTS, max_new_tokens=4)
    assert rv == pv == 4 and (pb["policy_version"] == 4).all()
    np.testing.assert_array_equal(pb["actions"], rb["actions"])


def test_engine_adopt_mid_flight_keeps_lanes():
    """update_params between scheduler steps keeps the in-flight lanes:
    each request finishes its budget under the new weights, every token
    carries a log-prob, and the reference doing the same swap at the
    same step gives the same tokens."""
    jp, npp = _nano_params(7)
    jp2, npp2 = _nano_params(9)
    rec = Recorder()
    ref = JEngineRolloutActor("gpt", "nano", params=jp, max_lanes=2,
                              temperature=0.0)
    port = EngineRolloutActor("gpt", "nano", params=_port_params(npp),
                              max_lanes=2, temperature=0.0, device="cpu",
                              observer=rec)
    out = []
    for actor, weights in ((ref, jp2), (port, npp2)):
        eng = actor.engine
        hs = [eng.submit(p, max_new_tokens=8) for p in PROMPTS[:2]]
        for _ in range(3):
            assert eng.step()
        assert eng.num_active == 2
        assert actor.adopt(7, weights) == 7
        while eng.step():
            pass
        toks = [h.tokens(timeout=TIMEOUT) for h in hs]  # drains once
        assert all(len(t) == 8 and len(h.logps) == 8
                   for t, h in zip(toks, hs))
        assert all(np.isfinite(lp) and lp <= 0.0 for h in hs
                   for lp in h.logps)
        assert eng.stats()["policy_version"] == 7
        out.append(toks)
    assert out[0] == out[1]
    assert ("engine", "weights_swap") in rec.events


def test_env_rollout_actor_tags_versions_and_spans():
    rec = Recorder()
    ln = StaleTolerantLearner(4, 2, hidden=HIDDEN, device="cpu")
    actor = EnvRolloutActor("CartPole-v1", num_envs=3,
                            rollout_fragment_length=5, hidden=HIDDEN,
                            device="cpu", observer=rec)
    assert actor.adopt(3, ln.get_weights()) == 3 == actor.get_version()
    batch, version, metrics = actor.sample_versioned()
    assert version == 3 and metrics["env_steps"] == 15
    assert batch["obs"].shape == (5, 3, 4)
    assert batch["bootstrap_obs"].shape == (3, 4)
    assert (batch["policy_version"] == 3).all()
    assert rec.spans == [("rl", "adopt", 3), ("rl", "rollout", 3)]
    for a, b in zip(_leaves(actor.get_weights()), _leaves(ln.get_weights())):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------- stale-tolerant learner

def _fake_fragment(rng, T=8, B=4, obs_dim=4, num_actions=2):
    term = rng.random((T, B)) < 0.1
    return SampleBatch({
        SampleBatch.OBS: rng.normal(size=(T, B, obs_dim)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, num_actions,
                                          size=(T, B)).astype(np.int32),
        SampleBatch.ACTION_LOGP: np.full((T, B), -0.7, np.float32),
        SampleBatch.REWARDS: rng.normal(size=(T, B)).astype(np.float32),
        SampleBatch.TERMINATEDS: term,
        SampleBatch.TRUNCATEDS: np.zeros((T, B), np.bool_),
        "bootstrap_obs": rng.normal(size=(B, obs_dim)).astype(np.float32),
        "policy_version": np.ones((T, B), np.int32),
        "valid": np.ones((T, B), np.bool_),
    })


def test_learner_staleness_versioning_and_checkpoint_resume(tmp_path):
    rng = np.random.default_rng(0)
    rec = Recorder()
    ln = StaleTolerantLearner(4, 2, hidden=HIDDEN, seed=0, device="cpu",
                              ckpt_dir=str(tmp_path), ckpt_interval=2,
                              observer=rec)
    assert ln.version == 1
    m1 = ln.update(_fake_fragment(rng), behavior_version=1)
    assert m1["staleness"] == 0.0 and np.isfinite(m1["total_loss"])
    version, weights = ln.publish_boundary()
    assert version == 2 and weights is not None
    m2 = ln.update(_fake_fragment(rng), behavior_version=1)
    assert m2["staleness"] == 1.0
    assert rec.counts["rl_learner_updates"] == 2
    ln2 = StaleTolerantLearner(4, 2, hidden=HIDDEN, seed=123, device="cpu",
                               ckpt_dir=str(tmp_path))
    assert ln2.restore_latest() == 2
    assert ln2.version == 2 and ln2.num_updates == 2
    for a, b in zip(_leaves(ln.get_weights()), _leaves(ln2.get_weights())):
        np.testing.assert_array_equal(a, b)
    ln3 = StaleTolerantLearner(4, 2, hidden=HIDDEN, seed=0, device="cpu",
                               ckpt_dir=str(tmp_path / "empty"))
    assert ln3.restore_latest() is None


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_learner_checkpoints_cross_both_ways(saver, tmp_path):
    """One package's learner saves at update 2; the other restores it
    bit for bit (params, Adam moments and count, version) and its next
    update is the saver's, compared by update at 0.05 * lr."""
    rng = np.random.default_rng(1)
    batches = [_fake_fragment(rng) for _ in range(3)]

    def port(seed, d):
        return StaleTolerantLearner(4, 2, hidden=HIDDEN, seed=seed, lr=LR,
                                    device="cpu", ckpt_dir=d,
                                    ckpt_interval=2)

    def ref(seed, d):
        return JStaleTolerantLearner(4, 2, hidden=HIDDEN, seed=seed, lr=LR,
                                     ckpt_dir=d, ckpt_interval=2)

    make_saver, make_loader = (port, ref) if saver == "port" else (ref, port)
    a = make_saver(0, str(tmp_path))
    for b in batches[:2]:
        a.update(b, behavior_version=1)
    a.publish_boundary()
    b = make_loader(99, str(tmp_path))
    assert b.restore_latest() == 2 and b.version == 1 and b.num_updates == 2
    sa, sb = a.state_tree(), b.state_tree()
    for x, y in zip(_leaves(sa["params"]) + _leaves(sa["opt_state"]),
                    _leaves(sb["params"]) + _leaves(sb["opt_state"])):
        np.testing.assert_array_equal(x, y)
    before = _leaves(a.get_weights())
    a.version = b.version
    a.update(batches[2], behavior_version=1)
    b.update(batches[2], behavior_version=1)
    for w0, wa, wb in zip(before, _leaves(a.get_weights()),
                          _leaves(b.get_weights())):
        np.testing.assert_allclose(wb - w0, wa - w0, rtol=0, atol=0.05 * LR)


# ------------------------------------------------- through the runtime

def _podracer_config(**training):
    return (PodracerConfig()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=1, num_envs_per_worker=4,
                      rollout_fragment_length=8)
            .training(model_hidden=HIDDEN, **training)
            .resources(runtime=ray_tpu, device="cpu", rollout_device="cpu")
            .debugging(seed=0))


def test_podracer_needs_a_runtime():
    with pytest.raises(ValueError, match="runtime"):
        PodracerConfig().resources(device="cpu",
                                   rollout_device="cpu").build()


class _LocalRuntime:
    """A runtime handle whose "remote" actors are built in this process
    (enough to see a constructor refuse)."""

    def remote(self, **_):
        return lambda cls: types.SimpleNamespace(
            remote=lambda **kw: cls(**kw))


@pytest.mark.parametrize("name", ["StaleTolerantLearner",
                                  "EngineRolloutActor"])
def test_entry_points_need_a_card_unless_given_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    make = {"StaleTolerantLearner": lambda **kw: StaleTolerantLearner(
                4, 2, hidden=HIDDEN, **kw),
            "EngineRolloutActor": lambda **kw: EngineRolloutActor(
                "gpt", "nano", max_lanes=1, **kw)}[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    make(device="cpu")


@pytest.mark.parametrize("config", [IMPALAConfig, PodracerConfig])
def test_remote_gangs_need_a_card_by_default(config):
    """The config's devices default to None (CUDA) and reach the first
    worker's constructor."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        config().resources(runtime=_LocalRuntime()).build()


def test_podracer_k0_through_the_runtime_and_a_worker_kill(cluster):
    rec = Recorder()
    algo = _podracer_config(staleness_bound=0, min_updates_per_step=2,
                            queue_capacity=4).debugging(observer=rec).build()
    try:
        for _ in range(3):
            r = algo.train()
            assert r["learner/staleness"] == 0.0
            assert np.isfinite(r["learner/total_loss"])
        assert r["learner_updates_total"] >= 6
        assert rec.counts["rl_weight_publishes"] >= 6
        # Every trained batch, not only each iteration's last, was fresh.
        assert set(rec.counts["rl_update_staleness/values"]) == {0.0}

        ray_tpu.kill(algo.workers.remote_workers[0])
        for _ in range(3):
            r = algo.train()
            assert r["learner/staleness"] == 0.0
        assert algo.workers.num_remote_workers == 1
        assert rec.counts["rl_workers_replaced"] == 1
        assert ("rl", "worker_replaced") in rec.events
        # The replacement adopted the published weights: once the gang
        # settles, its version and weights are the learner's.
        (worker,) = algo.workers.remote_workers
        for _ in range(50):
            if ray_tpu.get(worker.get_version.remote(),
                           timeout=TIMEOUT) == \
                    algo.publisher.version:
                break
            time.sleep(0.1)
        assert ray_tpu.get(worker.get_version.remote(),
                           timeout=TIMEOUT) == \
            algo.publisher.version == algo.learner.version
        for x, y in zip(_leaves(ray_tpu.get(worker.get_weights.remote(),
                                            timeout=TIMEOUT)),
                        _leaves(algo.learner.get_weights())):
            np.testing.assert_array_equal(x, y)
    finally:
        algo.stop()


def test_impala_consumes_remote_fragments(cluster):
    cfg = (IMPALAConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=1, num_envs_per_worker=4,
                     rollout_fragment_length=8)
           .training(model_hidden=HIDDEN, min_updates_per_step=2)
           .resources(runtime=ray_tpu, device="cpu", rollout_device="cpu"))
    algo = cfg.build()
    try:
        r = algo.train()
        r = algo.train()
        assert r["learner_updates_total"] >= 4
        assert np.isfinite(r["learner/total_loss"])
        assert r["timesteps_total"] >= 4 * 32
    finally:
        algo.stop()
