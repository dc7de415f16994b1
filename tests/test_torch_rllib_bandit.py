"""The port's linear bandits (ray_tpu_torch/rllib/bandit.py) against the
reference's (ray_tpu/rllib/bandit.py), on the CPU:

- `LinearBanditVector` gives the reference's contexts, arm parameters
  and rewards for the same seed and arms;
- LinUCB and LinTS over 15 `train()` calls (tests/test_rllib.py's seeds
  7 and 11): the same arms at every step, `A_inv` and `b` within 1e-10;
  LinTS draws with the reference's `default_rng(seed + 99)`;
- a batch whose rows pick one arm twice: the second row sees the first
  row's Sherman-Morrison update, as in the reference (rows that all
  read the batch's starting inverse must miss);
- the reference's near-oracle gates and checkpoint round trip, run on
  the port; checkpoints cross both ways bit for bit; built on
  device=None without CUDA, both raise.
"""

import numpy as np
import pytest
import torch

from ray_tpu.rllib import bandit as jb
from ray_tpu_torch.rllib import LinTSConfig, LinUCBConfig
from ray_tpu_torch.rllib import bandit as pb

torch.set_num_threads(1)

ITERS = 15
STATE_TOL = 1e-10


def test_env_gives_the_references_contexts_and_rewards():
    ref, port = jb.LinearBanditVector(16, seed=5), pb.LinearBanditVector(
        16, seed=5)
    np.testing.assert_array_equal(port.theta, ref.theta)
    np.testing.assert_array_equal(port.reset_all(5), ref.reset_all(5))
    rng = np.random.default_rng(0)
    for _ in range(5):
        np.testing.assert_array_equal(port.expected_rewards(),
                                      ref.expected_rewards())
        arms = rng.integers(0, 3, 16)
        for a, b in zip(port.step(arms), ref.step(arms)):
            np.testing.assert_array_equal(a, b)
    assert port.drain_episode_metrics() == ref.drain_episode_metrics()


def _pair(kind: str, seed: int):
    ref_cfg, port_cfg = {"ucb": (jb.LinUCBConfig, LinUCBConfig),
                         "ts": (jb.LinTSConfig, LinTSConfig)}[kind]
    ref_cfg, port_cfg = ref_cfg(), port_cfg().resources(device="cpu")
    ref_cfg.seed = port_cfg.seed = seed
    return ref_cfg.build(), port_cfg.build()


def _record_arms(algo) -> list:
    arms, choose = [], algo._choose

    def recording(obs):
        out = choose(obs)
        arms.append(np.asarray(out))
        return out

    algo._choose = recording
    return arms


def _assert_state_close(port, ref):
    np.testing.assert_allclose(port.model.A_inv.numpy(), ref.model.A_inv,
                               rtol=STATE_TOL, atol=STATE_TOL)
    np.testing.assert_allclose(port.model.b.numpy(), ref.model.b,
                               rtol=STATE_TOL, atol=STATE_TOL)


@pytest.mark.parametrize("kind,seed", [("ucb", 7), ("ts", 11)])
def test_same_arms_and_state_over_15_calls(kind, seed):
    ref, port = _pair(kind, seed)
    ref_arms, port_arms = _record_arms(ref), _record_arms(port)
    for _ in range(ITERS):
        rr, pr = ref.train(), port.train()
        assert pr["mean_reward"] == rr["mean_reward"]
        _assert_state_close(port, ref)
    assert len(port_arms) == ITERS * 8
    for t, (a, b) in enumerate(zip(port_arms, ref_arms)):
        np.testing.assert_array_equal(a, b, err_msg=f"step {t}")
    assert port.model.A_inv.dtype == torch.float64
    np.testing.assert_allclose(port.model.theta().numpy(),
                               ref.model.theta(), rtol=STATE_TOL,
                               atol=STATE_TOL)


def test_rows_on_one_arm_update_in_order():
    ref = jb._LinearModel(3, 4)
    port = pb._LinearModel(3, 4, device="cpu")
    rng = np.random.default_rng(2)
    arms = np.array([1, 1, 0, 1, 2, 2])
    xs = rng.uniform(-1, 1, (6, 4))
    rs = rng.standard_normal(6)
    ref.update(arms, xs, rs)
    port.update(arms, torch.from_numpy(xs), torch.from_numpy(rs))
    np.testing.assert_allclose(port.A_inv.numpy(), ref.A_inv, rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(port.b.numpy(), ref.b, rtol=1e-12,
                               atol=1e-14)
    # Rows that all read the batch's starting A_inv (a scatter of
    # independent rank-1 updates) miss where one arm has several rows.
    start = np.stack([np.eye(4)] * 3)
    scattered = start.copy()
    for a, x in zip(arms, xs):
        aix = start[a] @ x
        scattered[a] -= np.outer(aix, aix) / (1.0 + x @ aix)
    assert np.abs(scattered[1] - ref.A_inv[1]).max() > 1e-2
    np.testing.assert_allclose(scattered[0], ref.A_inv[0], rtol=1e-12)


def _near_oracle(algo) -> tuple:
    """tests/test_rllib.py's gate: 50 fresh batches of contexts."""
    env = algo.env
    oracle, rnd, mine = [], [], []
    for _ in range(50):
        exp = env.expected_rewards()
        oracle.append(exp.max(-1).mean())
        rnd.append(exp.mean())
        arms = algo.compute_actions(algo._obs)
        mine.append(exp[np.arange(exp.shape[0]), arms].mean())
        algo._obs, _, _, _ = env.step(arms)
    return tuple(map(np.mean, (oracle, rnd, mine)))


@pytest.mark.parametrize("kind,seed,share", [("ucb", 7, 0.7),
                                             ("ts", 11, 0.6)])
def test_port_passes_the_references_gate(kind, seed, share):
    cfg = (LinUCBConfig() if kind == "ucb" else LinTSConfig()).resources(
        device="cpu")
    cfg.seed = seed
    algo = cfg.build()
    try:
        for _ in range(ITERS):
            algo.train()
        oracle_m, rnd_m, mine_m = _near_oracle(algo)
        assert mine_m > rnd_m + share * (oracle_m - rnd_m), \
            (mine_m, rnd_m, oracle_m)
        ckpt = algo.save()
        before = algo.model.theta().clone()
        algo.train()
        algo.restore(ckpt)
        assert torch.equal(algo.model.theta(), before)
    finally:
        algo.stop()


@pytest.mark.parametrize("kind", ["ucb", "ts"])
def test_checkpoints_cross_both_ways(kind):
    ref, port = _pair(kind, 3)
    for _ in range(3):
        ref.train(), port.train()
    fresh_ref, fresh_port = _pair(kind, 0)
    fresh_ref.restore(port.save())
    fresh_port.restore(ref.save())
    for got, want in ((fresh_ref.save_to_dict(), port.save_to_dict()),
                      (fresh_port.save_to_dict(), ref.save_to_dict())):
        assert set(got) == set(want) == {"A_inv", "b"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.float64
            np.testing.assert_array_equal(got[k], want[k])
    assert isinstance(port.save_to_dict()["A_inv"], np.ndarray)


def test_bandits_on_device_none_need_cuda():
    if torch.cuda.is_available():
        return
    for cfg in (LinUCBConfig(), LinTSConfig()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cfg.build()
