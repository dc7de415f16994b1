"""The Tune binding of the port's algorithms (ray_tpu_torch/rllib/
algorithm.py: `save`, `restore`, `as_trainable`; ray_tpu_torch/air/) against
the reference's, on the CPU:

- a PPO checkpoint round trip (tests/test_rllib.py's shape): weights bit
  for bit, the iteration count kept; the same for multi-agent PPO's
  policy map and for QMIX;
- a port PPO checkpoint restores in the reference's PPO, weights bit for
  bit; the reference's jitted update then needs optax's own state
  classes, which `as_optax` puts in place of the port's optax-named
  tuples (the port imports no optax); a reference checkpoint restores in
  the port's as it is; each trains on;
- `as_trainable` with a plain report function, and under the
  reference's `tune.run` with `ray_tpu` as the runtime handle, whose
  `tune.report` the trainable calls (device="cpu");
- without a report function or a runtime with `tune.report`,
  `as_trainable` refuses.
"""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.tune  # noqa: F401  (the handle's Tune: ray_tpu.tune.report)
from ray_tpu.rllib.ppo import PPOConfig as JPPOConfig
from ray_tpu_torch.air import Checkpoint
from ray_tpu_torch.rllib import PPO, PPOConfig, QMixConfig
from tests.test_torch_rllib import _leaves
from tests.test_torch_rllib_continuous import as_optax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu.init(num_cpus=4, object_store_memory=64 << 20)
    yield info
    ray_tpu.shutdown()


def _cartpole(cls=PPOConfig, device="cpu"):
    cfg = (cls().environment("CartPole-v1")
           .rollouts(num_rollout_workers=0, num_envs_per_worker=4,
                     rollout_fragment_length=16)
           .training(train_batch_size=64, sgd_minibatch_size=32,
                     num_sgd_iter=2))
    if device:
        cfg = cfg.resources(device=device, rollout_device=device)
    return cfg


def _same_weights(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la and len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def test_ppo_checkpoint_roundtrip():
    cfg = _cartpole()
    algo = cfg.build()
    algo.train()
    ckpt = algo.save()
    assert isinstance(ckpt, Checkpoint)
    state = ckpt.to_dict()
    assert state["iteration"] == 1 and state["total_env_steps"] == 64
    algo2 = cfg.build()
    algo2.restore(ckpt)
    _same_weights(algo.learner.get_weights(), algo2.learner.get_weights())
    _same_weights(algo.learner.get_state(), algo2.learner.get_state())
    _same_weights(algo2.learner.get_weights(),
                  algo2.workers.local_worker.get_weights())
    assert algo2.iteration == algo.iteration
    assert algo2.total_env_steps == algo.total_env_steps
    algo.stop()
    algo2.stop()


def test_port_checkpoint_restores_in_the_reference():
    port = _cartpole().build()
    port.train()
    ckpt = port.save()
    ref = _cartpole(JPPOConfig, device=None).build()
    ref.restore(ckpt)
    _same_weights(ref.learner.get_weights(), port.learner.get_weights())
    _same_weights(ref.learner.get_state(), port.learner.get_state())
    assert ref.iteration == port.iteration == 1
    ref.restore(Checkpoint.from_dict(as_optax(ckpt.to_dict())))
    r = ref.train()                         # the reference trains on
    assert r["training_iteration"] == 2
    assert np.isfinite(r["learner/total_loss"])
    port.stop()
    ref.stop()


def test_reference_checkpoint_restores_in_the_port():
    ref = _cartpole(JPPOConfig, device=None).build()
    ref.train()
    ref.train()
    port = _cartpole().build()
    port.restore(ref.save())
    _same_weights(port.learner.get_weights(), ref.learner.get_weights())
    _same_weights(port.workers.local_worker.get_weights(),
                  ref.learner.get_weights())
    assert port.iteration == 2
    assert port.learner.opt.count == 8     # 2 iterations x 2 x 2 minibatches
    r = port.train()
    assert r["training_iteration"] == 3
    assert np.isfinite(r["learner/total_loss"])
    port.stop()
    ref.stop()


def test_multi_agent_and_qmix_checkpoints_round_trip():
    cfg = (PPOConfig().environment("coop-match")
           .rollouts(num_rollout_workers=0, num_envs_per_worker=4,
                     rollout_fragment_length=16)
           .multi_agent(policies=["p0", "p1"],
                        policy_mapping_fn=lambda a: "p" + a[1])
           .training(train_batch_size=64, sgd_minibatch_size=32,
                     num_sgd_iter=1)
           .resources(device="cpu", rollout_device="cpu"))
    algo = cfg.build()
    algo.train()
    algo2 = cfg.build()
    algo2.restore(algo.save())
    for pid in ("p0", "p1"):
        _same_weights(algo2.learners[pid].get_state(),
                      algo.learners[pid].get_state())
        _same_weights(algo2.workers.local_worker.get_weights()[pid],
                      algo.learners[pid].get_weights())
    algo.stop()
    algo2.stop()
    qcfg = QMixConfig().resources(device="cpu")
    q = qcfg.build()
    q.train()
    q2 = qcfg.build()
    q2.restore(q.save())
    _same_weights(q2.save_to_dict(), q.save_to_dict())
    assert q2.iteration == 1 and q2.evaluate_greedy() == q.evaluate_greedy()


def test_as_trainable_reports_every_iteration():
    results = []
    trainable = PPO.as_trainable(_cartpole(), stop_iters=3,
                                 report=results.append)
    trainable({"lr": 1e-4, "not_a_knob": 1})
    assert len(results) == 3
    assert [r["training_iteration"] for r in results] == [1, 2, 3]
    assert all("episode_reward_mean" in r for r in results)
    # stop_reward ends the loop early.
    results.clear()
    PPO.as_trainable(_cartpole(), stop_iters=3, stop_reward=-1.0,
                     report=results.append)(None)
    assert len(results) == 1


def test_as_trainable_needs_a_report_handle():
    with pytest.raises(ValueError, match="report"):
        PPO.as_trainable(_cartpole(), stop_iters=1)


def test_ppo_under_the_references_tune(cluster):
    """The reference's test_ppo_under_tune with the port's PPO: a grid
    of two learning rates, 3 iterations each, the trials on the CPU,
    Tune's report reached through the runtime handle."""
    from ray_tpu import tune

    trainable = PPO.as_trainable(
        _cartpole().resources(runtime=ray_tpu), stop_iters=3)
    results = tune.run(trainable,
                       config={"lr": tune.grid_search([1e-4, 5e-4])},
                       metric="episode_reward_mean", mode="max",
                       resources_per_trial={"CPU": 1})
    assert len(results) == 2
    assert not results.errors
