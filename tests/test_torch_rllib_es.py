"""The port's evolution strategies (ray_tpu_torch/rllib/es.py, ars.py)
against the reference's (ray_tpu/rllib/es.py, ars.py), on the CPU, with
no cluster: the reference's worker runs in process as
`EvalWorker._cls(...)`, the port's through an in-process runtime handle.

- `_init_flat` gives the same bits in both packages, and the population
  forward (one `baddbmm` per layer over views of the [B, dim] parameter
  matrix) agrees with the reference's jit(vmap(apply_one)) within 1e-5
  at 4->32->32->2 (discrete) and 3->32->32->1 (continuous), B = 48;
- `evaluate` on the same env, seed, theta, seeds and sigma, with and
  without `obs_stats`: returns, lengths and obs_n equal, the moments
  within 1e-9 relative, every step's forward within 1e-5; a lane whose
  argmax flips at a near-tie is reported with its logit gap;
- `centered_ranks` with ties equal to the reference's bit for bit;
- three ES and three ARS `training_step`s with both algorithms fed the
  same evaluation results (`_fan_out` replaced on both): theta within
  1e-6 relative, ES's Adam moments f64 after step 1 and within 1e-9,
  ARS's filter state equal;
- the port's `_fan_out` through the handle gives the reference workers'
  results; checkpoints cross both ways bit for bit; ES without a
  runtime handle, or on device=None without CUDA, raises.
"""

import types

import numpy as np
import pytest
import torch

from ray_tpu.rllib import ars as jars
from ray_tpu.rllib import es as jes
from ray_tpu_torch.rllib import ARSConfig, ESConfig
from ray_tpu_torch.rllib import es as pes

torch.set_num_threads(1)

HIDDEN = (32, 32)
FWD_TOL = 1e-5


class InlineRuntime:
    """The runtime handle's calls in this process: an actor's method runs
    when it is called and its result is its own ref."""

    def __init__(self):
        self.killed = []

    @staticmethod
    def actor(obj):
        return types.SimpleNamespace(**{
            name: types.SimpleNamespace(remote=getattr(obj, name))
            for name in dir(obj) if not name.startswith("__")}, obj=obj)

    def remote(self, **_):
        return lambda cls: types.SimpleNamespace(
            remote=lambda **kw: self.actor(cls(**kw)))

    def get(self, refs, timeout=None):
        assert timeout is not None
        return refs

    def kill(self, actor):
        self.killed.append(actor)


@pytest.fixture
def ref_workers_in_process(monkeypatch):
    """The reference's ES builds its workers in process."""
    cls = jes.EvalWorker._cls

    class Workers:
        @staticmethod
        def options(**_):
            return Workers

        @staticmethod
        def remote(*args):
            return cls(*args)

    monkeypatch.setattr(jes, "EvalWorker", Workers)
    return cls


# ------------------------------------------------------------- forward

@pytest.mark.parametrize("obs_dim,out_dim", [(4, 2), (3, 1)],
                         ids=["discrete", "continuous"])
def test_population_forward_matches_make_apply(obs_dim, out_dim):
    shapes = pes._mlp_shapes(obs_dim, HIDDEN, out_dim)
    assert shapes == jes._mlp_shapes(obs_dim, HIDDEN, out_dim)
    theta = pes._init_flat(obs_dim, HIDDEN, out_dim, seed=3)
    want = jes._init_flat(obs_dim, HIDDEN, out_dim, seed=3)
    assert theta.dtype == want.dtype and (theta == want).all()
    rng = np.random.default_rng(0)
    pop = (theta + 0.5 * rng.standard_normal((48, theta.size))).astype(
        np.float32)
    obs = rng.standard_normal((48, obs_dim)).astype(np.float32)
    ref = np.asarray(jes._make_apply(obs_dim, HIDDEN, out_dim)(pop, obs))
    got = pes.population_forward(
        pes.population_layers(torch.from_numpy(pop), shapes),
        torch.from_numpy(obs)).numpy()
    assert got.shape == ref.shape == (48, out_dim)
    np.testing.assert_allclose(got, ref, atol=FWD_TOL, rtol=FWD_TOL)
    # The flat layout is W row-major [n_in, n_out], then b: a transposed
    # first layer must miss.
    (w, b), *rest = pes.population_layers(torch.from_numpy(pop), shapes)
    wt = w.reshape(48, -1).reshape(48, w.shape[2], w.shape[1]).transpose(
        1, 2)
    bad = pes.population_forward([(wt, b)] + rest,
                                 torch.from_numpy(obs)).numpy()
    assert np.abs(bad - ref).max() > 1e-2


# ------------------------------------------------------------- evaluate

class _Recorder:
    """Keeps every forward output of one evaluate call."""

    def __init__(self, fn):
        self.fn, self.outs = fn, []

    def __call__(self, *args):
        out = self.fn(*args)
        self.outs.append(np.array(out))
        return out


def _flips(ref_outs, port_outs) -> list:
    """(step, lane, reference gap, port gap) wherever the argmax differs."""
    flips = []
    for t, (r, p) in enumerate(zip(ref_outs, port_outs)):
        for lane in np.nonzero(r.argmax(-1) != p.argmax(-1))[0]:
            flips.append((t, int(lane), float(np.ptp(r[lane])),
                          float(np.ptp(p[lane]))))
    return flips


@pytest.mark.parametrize("normalize", [False, True],
                         ids=["raw", "obs_stats"])
def test_evaluate_matches_reference(normalize, monkeypatch):
    ref = jes.EvalWorker._cls("CartPole-v1", HIDDEN, 7919, 300)
    port = pes.EvalWorker("CartPole-v1", HIDDEN, 7919, 300, device="cpu")
    ref._apply = _Recorder(jes._make_apply(4, HIDDEN, 2))
    rec = _Recorder(pes.population_forward)
    monkeypatch.setattr(pes, "population_forward", rec)
    theta = jes._init_flat(4, HIDDEN, 2, seed=0)
    seeds = [int(s) for s in
             np.random.default_rng(0).integers(0, 2 ** 31 - 1, size=12)]
    stats = ((np.array([0.1, -0.2, 0.01, 0.3], np.float32),
              np.array([0.5, 1.5, 0.1, 2.0], np.float32))
             if normalize else None)
    for _ in range(2):                # the second call reuses the lanes
        want = ref.evaluate(theta, seeds, 0.08, stats)
        got = port.evaluate(theta, seeds, 0.08, stats)
    flips = _flips(ref._apply.outs, rec.outs)
    assert not flips, f"argmax near-tie flips (step, lane, gaps): {flips}"
    for r, p in zip(ref._apply.outs, rec.outs):
        np.testing.assert_allclose(p, r, atol=FWD_TOL, rtol=FWD_TOL)
    for key in ("r_plus", "r_minus", "lengths", "obs_n"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("obs_sum", "obs_sq"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                   err_msg=key)
    assert got["lengths"].max() > 20 and len(set(got["r_plus"])) > 3


def test_centered_ranks_ties_match_reference():
    rng = np.random.default_rng(0)
    for x in (np.array([[1.0, 3.0, 1.0, 2.0], [3.0, 0.0, 1.0, 1.0]]),
              rng.integers(0, 5, size=(2, 32)).astype(np.float64),
              np.full((2, 8), 9.0)):
        got, want = pes.centered_ranks(x), jes.centered_ranks(x)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ algorithms

def _configs(ref_cfg, port_cfg, **settings):
    for cfg in (ref_cfg, port_cfg):
        cfg.environment("CartPole-v1").rollouts(
            num_rollout_workers=2).debugging(seed=4)
        for k, v in settings.items():
            setattr(cfg, k, v)
    return ref_cfg.build(), port_cfg.resources(
        runtime=InlineRuntime(), device="cpu").build()


def _feed_both(ref, port):
    """Each ES round: the reference's in-process workers evaluate the
    reference's theta; the port's algorithm gets the same results (and
    must ask for the same seeds and obs_stats)."""
    fed = []

    def ref_fan_out(seeds, obs_stats=None):
        shards = [s for s in np.array_split(seeds, len(ref.workers))
                  if len(s)]
        results = [w.evaluate(ref.theta, [int(s) for s in shard],
                              ref.config.noise_stdev, obs_stats)
                   for w, shard in zip(ref.workers, shards)]
        fed.append((seeds.copy(), obs_stats, results, shards))
        return results, shards

    def port_fan_out(seeds, obs_stats=None):
        want_seeds, want_stats, results, shards = fed.pop(0)
        np.testing.assert_array_equal(seeds, want_seeds)
        assert (obs_stats is None) == (want_stats is None)
        for a, b in zip(obs_stats or (), want_stats or ()):
            np.testing.assert_array_equal(a, b)
        return results, shards

    ref._fan_out, port._fan_out = ref_fan_out, port_fan_out


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


ES_SETTINGS = dict(episodes_per_batch=8, episode_horizon=100,
                   noise_stdev=0.08, lr=0.05)


def test_es_training_steps_match_reference(ref_workers_in_process):
    ref, port = _configs(jes.ESConfig(), ESConfig(), **ES_SETTINGS)
    assert (port.theta == ref.theta).all()
    _feed_both(ref, port)
    for step in range(3):
        rr, pr = ref.train(), port.train()
        assert port.theta.dtype == ref.theta.dtype == np.float32
        assert _rel(port.theta, ref.theta) <= 1e-6
        for name in ("_adam_m", "_adam_v"):
            a, b = getattr(port, name), getattr(ref, name)
            assert a.dtype == b.dtype == np.float64, (step, name)
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)
        assert pr["episode_reward_mean"] == rr["episode_reward_mean"]
        assert pr["timesteps_total"] == rr["timesteps_total"]
    assert port._adam_t == ref._adam_t == 3
    port.stop()
    assert len(port.config.runtime.killed) == 2


def test_ars_training_steps_match_reference(ref_workers_in_process):
    ref, port = _configs(jars.ARSConfig(), ARSConfig(), episodes_per_batch=8,
                         top_directions=4, episode_horizon=100,
                         noise_stdev=0.1, lr=0.05)
    _feed_both(ref, port)
    for _ in range(3):
        rr, pr = ref.train(), port.train()
        assert port.theta.dtype == np.float32
        assert _rel(port.theta, ref.theta) <= 1e-6
        assert pr["sigma_r"] == rr["sigma_r"]
        assert port._obs_n == ref._obs_n
        np.testing.assert_array_equal(port._obs_sum, ref._obs_sum)
        np.testing.assert_array_equal(port._obs_sq, ref._obs_sq)
    assert port._obs_n > 100


def test_fan_out_through_the_handle(ref_workers_in_process):
    ref, port = _configs(jes.ESConfig(), ESConfig(), **ES_SETTINGS)
    seeds = np.random.default_rng(1).integers(0, 2 ** 31 - 1, size=8)
    got, shards = port._fan_out(seeds)
    assert [len(s) for s in shards] == [4, 4]
    for w, shard, res in zip(ref.workers, shards, got):
        want = w.evaluate(ref.theta, [int(s) for s in shard], 0.08)
        for key in ("r_plus", "r_minus", "lengths"):
            np.testing.assert_array_equal(res[key], want[key])
    # The workers' seeds and the shipped env creator.
    assert [w.obj._seed for w in port.workers] == [4 + 7919, 4 + 2 * 7919]
    assert callable(port.workers[0].obj._env_spec)


def _assert_same_state(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("algo", ["es", "ars"])
def test_checkpoints_cross_both_ways(algo, ref_workers_in_process):
    make = {"es": (jes.ESConfig, ESConfig),
            "ars": (jars.ARSConfig, ARSConfig)}[algo]
    ref, port = _configs(make[0](), make[1](), **ES_SETTINGS)
    _feed_both(ref, port)
    for _ in range(2):
        ref.train(), port.train()
    # port -> reference
    fresh_ref, _ = _configs(make[0](), make[1](), **ES_SETTINGS)
    fresh_ref.restore(port.save())
    _assert_same_state(fresh_ref.save_to_dict(), port.save_to_dict())
    assert fresh_ref.iteration == 2
    # reference -> port
    _, fresh_port = _configs(make[0](), make[1](), **ES_SETTINGS)
    fresh_port.restore(ref.save())
    _assert_same_state(fresh_port.save_to_dict(), ref.save_to_dict())
    # A port checkpoint is a copy: training on does not change it.
    ckpt = port.save()
    theta = port.theta.copy()
    _feed_both(ref, port)
    ref.train(), port.train()
    port.restore(ckpt)
    assert (port.theta == theta).all()


def test_es_needs_a_runtime_handle_and_a_device():
    with pytest.raises(ValueError, match=r"resources\(runtime="):
        ESConfig().build()
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ESConfig().resources(runtime=InlineRuntime()).build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ARSConfig().resources(runtime=InlineRuntime()).build()
