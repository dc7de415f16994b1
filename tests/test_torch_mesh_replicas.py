"""The port's stage axis in the LM train step and its data-parallel
replicas (the RL learners' `learner_mesh`, ResNet under a mesh) against
the JAX package under the same meshes, on the CPU, f32.

JAX runs on the first 4 virtual CPU devices of tests/conftest.py; the
port on one group of 4 gloo ranks spawned by `run_ranks` for the module
(`rank_bodies.sequence`, rank r where JAX's device r stands), the
reference's side computed while the ranks run.  Held:

- gpt nano and llama-tiny on MeshConfig(data=2, stage=2), 3 AdamW steps
  from the reference's initial weights: every rank's losses (and one
  more step's) within 1e-5 relative of the reference's jitted mesh
  step, each leaf's update within UPDATE_REL_TOL of the reference's in
  L2 norm; the two stage replicas of each data rank equal to the last
  bit (losses and a sha256 of their params): no gradient is summed over
  `stage`, and the rows split over data only;
- ResNet (tests/test_torch_resnet.py's basic-cifar config, width 8,
  16 x 16 inputs) on MeshConfig(data=2, stage=2), 3 AdamW
  steps on batches of 8: losses within 1e-5 relative and accuracies
  equal to the reference's mesh step and to the port's one-device step,
  every leaf's update within 0.05 * lr of both (as that file holds one
  device to optax), and every leaf within 1e-6 relative of one device
  averaging the two half batches' gradients (`split=2`, what chip_smoke
  holds the card's run against); on batches of 5 rows (3 and 2 a data
  rank, GSPMD's split of an uneven batch), the same against the
  reference's mesh step on the unplaced batches and against `split=2`;
- `TorchLearner` on data = 4 at tests/test_rllib_dp.py:41's shapes (512
  rows, obs 6, 3 actions, 4 epochs of 128): fed the reference's own
  permutations, its weights within 2e-5 + 1e-4 relative of the
  reference's dp-4 learner (optax and torch sum in other orders); on its
  own generator, within the reference test's rtol 1e-4, atol 1e-5 of
  the port's one-device learner, and the mean total loss within 1e-3 of
  it; the V-trace learner at :68's shapes (T 16, B 8) on data = 4
  likewise against the reference's dp-4 and the port's one device;
- PPO with `.resources(learner_mesh=MeshConfig(data=2))` for one
  train(): a learner group of 2 ranks, its weights within rtol 1e-4,
  atol 1e-5 of the one-device PPO's, its ranks ended by `stop()`; its
  `save()` restores a one-device PPO to the same weights, and it
  restores from a one-device checkpoint (the port's optax look-alikes,
  and optax's own types) to them again, its ranks importing neither
  optax nor JAX;
- `RankGang`: a rank keeps its state between calls; a rank that
  raises, and one that hangs in a collective, fail the caller within
  the timeout and close the gang.
"""

import concurrent.futures
import functools
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import llama as jllama
from ray_tpu.models import resnet as jresnet
from ray_tpu.parallel import (MeshConfig as JMeshConfig,
                              create_mesh as jcreate_mesh,
                              shard_batch as jshard_batch)
from ray_tpu.rllib.impala import IMPALAConfig as JIMPALAConfig
from ray_tpu.rllib.impala import _VTraceLearner as JVTraceLearner
from ray_tpu.rllib.learner import JaxLearner
from ray_tpu.rllib.learner import ppo_loss as jppo_loss
from ray_tpu_torch.air import Checkpoint
from ray_tpu_torch.models import convert, gpt, llama, resnet
from ray_tpu_torch.models.convert import resnet_state_dict, resnet_variables
from ray_tpu_torch.parallel import MeshConfig, rank_bodies
from ray_tpu_torch.parallel.launch import RankGang, run_ranks
from ray_tpu_torch.rllib import IMPALAConfig, PPOConfig, SampleBatch
from ray_tpu_torch.rllib.impala import _VTraceLearner
from ray_tpu_torch.rllib.learner import TorchLearner, ppo_loss

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

RANK_TIMEOUT_S = 240
LR = 1e-3
STEPS = 3
UPDATE_REL_TOL = 1e-3       # tests/test_torch_mesh_train.py's
STAGE = dict(data=2, stage=2)
MODELS = {"gpt": (jgpt, gpt, "nano"), "llama": (jllama, llama,
                                                 "llama-tiny")}
RESNET_SHAPE = (16, 16, 3)
PPO_CFG = {"lr": 3e-3, "grad_clip": 0.5, "num_sgd_iter": 4,
           "sgd_minibatch_size": 128, "clip_param": 0.2}
K = 4


def _jmesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return jcreate_mesh(JMeshConfig(**sizes), devices=jax.devices()[:n])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _slices(index):
    return tuple(slice(a, b) for a, b in index)


# ------------------------------------------------------------ LM on stage


@functools.cache
def _start(model):
    jmod, _, name = MODELS[model]
    return jax.tree.map(np.asarray, jmod.init_params(jmod.CONFIGS[name],
                                                     jax.random.key(4)))


@functools.cache
def _batches(model):
    rng = np.random.default_rng(31)
    return [rng.integers(0, 512, (8, 32)).astype(np.int32)
            for _ in range(STEPS)]


@functools.cache
def _reference_train(model):
    jmod, _, name = MODELS[model]
    mesh = _jmesh(STAGE)
    init, step = jmod.make_train_step(jmod.CONFIGS[name], optax.adamw(LR),
                                      mesh)
    state = init(jax.random.key(4))
    step = jax.jit(step)
    losses = []
    for tokens in _batches(model):
        state, m = step(state, jshard_batch(mesh, {"tokens": tokens}))
        losses.append(float(m["loss"]))
    final = jax.tree.map(np.asarray, state["params"])
    _, m = step(state, jshard_batch(mesh, {"tokens": _batches(model)[-1]}))
    return losses, final, float(m["loss"])


# ---------------------------------------------------------------- ResNet


def _resnet_configs():
    kw = dict(stage_sizes=(1, 1), width=8, num_groups=2, num_classes=10,
              bottleneck=False, cifar_stem=True)
    return (jresnet.ResNetConfig(dtype=jnp.float32, **kw),
            resnet.ResNetConfig(dtype=torch.float32, **kw))


@functools.cache
def _resnet_batches():
    rng = np.random.default_rng(12)
    return [{"images": rng.standard_normal((8,) + RESNET_SHAPE).astype(
        np.float32), "labels": rng.integers(0, 10, (8,)).astype(np.int32)}
        for _ in range(STEPS)]


@functools.cache
def _reference_resnet():
    """The reference's start and final flax variables and its losses and
    accuracies on the data2/stage2 mesh."""
    cj, _ = _resnet_configs()
    mesh = _jmesh(STAGE)
    init, step = jresnet.make_train_step(cj, optax.adamw(LR), mesh,
                                         input_shape=RESNET_SHAPE)
    state = init(jax.random.key(0))
    start = jax.tree.map(np.array, state["params"])
    step = jax.jit(step)
    losses, accs = [], []
    for b in _resnet_batches():
        state, m = step(state, jshard_batch(mesh, b))
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    return start, jax.tree.map(np.asarray, state["params"]), losses, accs


@functools.cache
def _resnet_uneven_batches():
    rng = np.random.default_rng(16)
    return [{"images": rng.standard_normal((5,) + RESNET_SHAPE).astype(
        np.float32), "labels": rng.integers(0, 10, (5,)).astype(np.int32)}
        for _ in range(STEPS)]


@functools.cache
def _reference_resnet_uneven():
    """The reference's final flax variables, losses and accuracies on
    the data2/stage2 mesh from `_reference_resnet`'s start, each batch of
    5 rows passed unplaced (its jit pads the rows over data)."""
    cj, _ = _resnet_configs()
    init, step = jresnet.make_train_step(cj, optax.adamw(LR),
                                         _jmesh(STAGE),
                                         input_shape=RESNET_SHAPE)
    state = init(jax.random.key(0))
    step = jax.jit(step)
    losses, accs = [], []
    for b in _resnet_uneven_batches():
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    return jax.tree.map(np.asarray, state["params"]), losses, accs


@functools.cache
def _resnet_start_dict():
    _, ct = _resnet_configs()
    return {k: v.numpy() for k, v in resnet_state_dict(
        _reference_resnet()[0], ct, device="cpu").items()}


# ---------------------------------------------------------------- learners


def _fake_ppo_batch(n=512, obs_dim=6, num_actions=3, seed=0):
    rng = np.random.default_rng(seed)
    return SampleBatch({
        SampleBatch.OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, num_actions, size=n)
        .astype(np.int32),
        SampleBatch.ACTION_LOGP: rng.normal(size=n).astype(np.float32)
        * 0.1 - 1.0,
        SampleBatch.ADVANTAGES: rng.normal(size=n).astype(np.float32),
        SampleBatch.VALUE_TARGETS: rng.normal(size=n).astype(np.float32),
    })


def _vtrace_batch():
    T, B, obs_dim, acts = 16, 8, 4, 2
    rng = np.random.default_rng(1)
    return SampleBatch({
        SampleBatch.OBS: rng.normal(size=(T, B, obs_dim))
        .astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, acts, size=(T, B))
        .astype(np.int32),
        SampleBatch.ACTION_LOGP: (rng.normal(size=(T, B)) * 0.1 - 0.7)
        .astype(np.float32),
        SampleBatch.REWARDS: rng.normal(size=(T, B)).astype(np.float32),
        SampleBatch.TERMINATEDS: np.zeros((T, B), bool),
        SampleBatch.TRUNCATEDS: np.zeros((T, B), bool),
        "bootstrap_obs": rng.normal(size=(B, obs_dim)).astype(np.float32),
    })


def _plain(tree):
    """Namedtuples as tuples, leaves as numpy: a learner state that a
    rank unpickles without optax (the learners read either)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_plain(v) for v in tree)
    return np.asarray(tree)


@functools.cache
def _reference_ppo_start():
    """The reference's dp-4 learner, its initial state and the
    permutations its update will draw (its own key arithmetic)."""
    ln = JaxLearner(6, 3, loss_fn=jppo_loss, config=PPO_CFG, seed=7,
                    mesh=_jmesh(dict(data=K, fsdp=1)))
    _, sub = jax.random.split(ln._rng)
    perms = [np.asarray(jax.random.permutation(r, 512))
             for r in jax.random.split(sub, PPO_CFG["num_sgd_iter"])]
    return ln, _np(ln.get_state()), perms


@functools.cache
def _reference_ppo():
    """The reference dp-4 learner's metrics and weights after its
    update."""
    ln = _reference_ppo_start()[0]
    metrics = ln.update(_fake_ppo_batch())
    return metrics, _np(ln.get_weights())


def _port_ppo(device="cpu"):
    return TorchLearner(6, 3, loss_fn=ppo_loss, config=PPO_CFG, seed=7,
                        device=device)


@functools.cache
def _reference_vtrace_start():
    ln = JVTraceLearner(4, 2, JIMPALAConfig(), (32,), 3,
                        mesh=_jmesh(dict(data=K, fsdp=1)))
    return ln, _np(ln.get_state())


@functools.cache
def _reference_vtrace():
    ln = _reference_vtrace_start()[0]
    metrics = ln.update(_vtrace_batch())
    return metrics, _np(ln.get_weights())


def _port_vtrace(device="cpu"):
    return _VTraceLearner(4, 2, IMPALAConfig(), (32,), 3, device=device)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    calls = {}
    for model, (_, mod, name) in MODELS.items():
        calls[model] = ("train", (model, mod.CONFIGS[name], STAGE,
                                  _start(model), _batches(model), LR,
                                  "cpu", True, None, None, None, True))
    _, ct = _resnet_configs()
    calls["resnet"] = ("resnet", (STAGE, ct, _resnet_batches(), LR, "cpu",
                                  _resnet_start_dict()))
    calls["resnet_uneven"] = ("resnet", (STAGE, ct, _resnet_uneven_batches(),
                                         LR, "cpu", _resnet_start_dict()))
    _, ref_state, perms = _reference_ppo_start()
    state = _plain(ref_state)
    ppo_args = ((6, 3), dict(loss_fn=ppo_loss, config=PPO_CFG, seed=7))
    calls["ppo_ref"] = ("learner", ("ppo",) + ppo_args
                        + (state, [_fake_ppo_batch()], perms))
    calls["ppo_own"] = ("learner", ("ppo",) + ppo_args
                        + (None, [_fake_ppo_batch()]))
    vt_args = ((4, 2, IMPALAConfig(), (32,), 3), {})
    calls["vtrace_ref"] = ("learner", ("vtrace",) + vt_args + (
        _plain(_reference_vtrace_start()[1]), [_vtrace_batch()]))
    calls["vtrace_own"] = ("learner", ("vtrace",) + vt_args
                           + (None, [_vtrace_batch()]))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(
            run_ranks, rank_bodies.sequence, 4, args=(list(calls.values()),),
            device="cpu", init_dir=str(tmp_path_factory.mktemp("replicas")),
            timeout_s=RANK_TIMEOUT_S)
        # XLA compiles outside the GIL: threads overlap the compiles.
        with concurrent.futures.ThreadPoolExecutor(3) as jax_pool:
            for done in [jax_pool.submit(fn) for fn in (
                    _reference_resnet, _reference_resnet_uneven,
                    functools.partial(_reference_train, "gpt"),
                    functools.partial(_reference_train, "llama"),
                    _reference_ppo, _reference_vtrace)]:
                done.result()
        out = running.result()
    return types.SimpleNamespace(**{
        name: [r[i] for r in out] for i, name in enumerate(calls)})


@pytest.mark.parametrize("model", list(MODELS))
def test_lm_step_on_data2_stage2_matches_the_reference(ranks, model):
    want, final, final_loss = _reference_train(model)
    start, final = _flat(_start(model)), _flat(final)
    got = {k: np.full(v.shape, np.nan, np.float32) for k, v in final.items()}
    for out in getattr(ranks, model):
        np.testing.assert_allclose(out["losses"] + [out["final_loss"]],
                                   want + [final_loss], rtol=1e-5)
        assert out["moments_placed_like_params"]
        for path, (index, data) in out["shards"].items():
            got[path][_slices(index)] = data
    for path, want_leaf in final.items():
        assert not np.isnan(got[path]).any(), path
        moved = want_leaf.astype(np.float64) - start[path]
        err = np.linalg.norm(got[path] - start[path] - moved)
        assert err <= UPDATE_REL_TOL * np.linalg.norm(moved), (path, err)


@pytest.mark.parametrize("model", list(MODELS))
def test_stage_replicas_are_equal_to_the_last_bit(ranks, model):
    runs = getattr(ranks, model)
    by_data = {}
    for out in runs:
        c = out["coordinate"]       # (data, fsdp, expert, seq, tensor, stage)
        by_data.setdefault(c[0], []).append(out)
    assert sorted(len(v) for v in by_data.values()) == [2, 2]
    for a, b in by_data.values():
        assert a["losses"] == b["losses"]
        assert a["final_loss"] == b["final_loss"]
        assert a["params_digest"] == b["params_digest"]
    # The data ranks hold other rows, so their losses differ from the
    # stage replicas' agreement only through the global mean: equal.
    assert runs[0]["losses"] == runs[2]["losses"]


def _resnet_updates_close(got: dict, want: dict, start: dict):
    for k, w in want.items():
        base = np.asarray(start[k], np.float64)
        np.testing.assert_allclose(np.asarray(got[k], np.float64) - base,
                                   np.asarray(w, np.float64) - base,
                                   atol=0.05 * LR, rtol=0, err_msg=k)


def test_resnet_on_data2_stage2_matches_the_reference_and_one_device(ranks):
    start, final, losses, accs = _reference_resnet()
    _, ct = _resnet_configs()
    one = rank_bodies.resnet(0, 1, None, ct, _resnet_batches(), LR, "cpu",
                             _resnet_start_dict())
    split = rank_bodies.resnet(0, 1, None, ct, _resnet_batches(), LR, "cpu",
                               _resnet_start_dict(), split=2)
    assert split["accuracies"] == one["accuracies"]
    np.testing.assert_allclose(one["losses"], losses, rtol=1e-5)
    want, begin = _flat(final), _flat(start)
    for out in ranks.resnet:
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
        assert out["accuracies"] == accs == one["accuracies"]
        model = resnet.ResNet(ct)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in out["final"].items()})
        _resnet_updates_close(_flat(resnet_variables(model)), want, begin)
        for k, v in out["final"].items():
            np.testing.assert_allclose(v - _resnet_start_dict()[k],
                                       one["final"][k]
                                       - _resnet_start_dict()[k],
                                       atol=0.05 * LR, rtol=0, err_msg=k)
            np.testing.assert_allclose(v, split["final"][k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_resnet_on_uneven_rows_matches_the_reference_and_split(ranks):
    """5 rows over data 2: 3 and 2 real a rank (a pad image on the
    second), every image weighted alike, as the reference's jitted step
    pads and weighs them."""
    start = _reference_resnet()[0]
    final, losses, accs = _reference_resnet_uneven()
    _, ct = _resnet_configs()
    split = rank_bodies.resnet(0, 1, None, ct, _resnet_uneven_batches(), LR,
                               "cpu", _resnet_start_dict(), split=2)
    want, begin = _flat(final), _flat(start)
    for out in ranks.resnet_uneven:
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
        assert out["accuracies"] == accs
        model = resnet.ResNet(ct)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in out["final"].items()})
        _resnet_updates_close(_flat(resnet_variables(model)), want, begin)
        for k, v in out["final"].items():
            np.testing.assert_allclose(v, split["final"][k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def _assert_weights_close(got, want, rtol, atol):
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_torch_learner_on_data4_matches_the_reference_dp_learner(ranks):
    metrics, weights = _reference_ppo()
    for out in ranks.ppo_ref:
        _assert_weights_close(out["weights"], weights, rtol=1e-4, atol=2e-5)
        assert abs(out["metrics"][0]["total_loss"]
                   - metrics["total_loss"]) < 1e-4


def test_torch_learner_on_data4_matches_one_device(ranks):
    single = _port_ppo()
    m1 = single.update(_fake_ppo_batch())
    for out in ranks.ppo_own:
        _assert_weights_close(out["weights"], single.get_weights(),
                              rtol=1e-4, atol=1e-5)
        assert abs(out["metrics"][0]["total_loss"] - m1["total_loss"]) < 1e-3


def test_vtrace_learner_on_data4_matches_the_reference_and_one_device(
        ranks):
    metrics, weights = _reference_vtrace()
    single = _port_vtrace()
    m1 = single.update(_vtrace_batch())
    for ref_out, own in zip(ranks.vtrace_ref, ranks.vtrace_own):
        _assert_weights_close(ref_out["weights"], weights, rtol=1e-4,
                              atol=2e-5)
        assert abs(ref_out["metrics"][0]["total_loss"]
                   - metrics["total_loss"]) < 1e-4
        _assert_weights_close(own["weights"], single.get_weights(),
                              rtol=1e-4, atol=1e-5)
        assert abs(own["metrics"][0]["total_loss"] - m1["total_loss"]) < 1e-3


def _ppo_cfg(mesh=None):
    cfg = (PPOConfig().rollouts(num_rollout_workers=0,
                                num_envs_per_worker=4,
                                rollout_fragment_length=32)
           .training(train_batch_size=128, sgd_minibatch_size=64,
                     num_sgd_iter=2)
           .resources(device="cpu", rollout_device="cpu"))
    return cfg if mesh is None else cfg.resources(learner_mesh=mesh)


def test_ppo_with_a_learner_mesh_trains_as_one_device():
    from ray_tpu_torch.rllib import LearnerGroup

    group, single = _ppo_cfg(MeshConfig(data=2)).build(), _ppo_cfg().build()
    try:
        assert isinstance(group.learner, LearnerGroup)
        assert group.learner.k == 2
        rg, rs = group.train(), single.train()
        assert rg["sampled_rows"] == rs["sampled_rows"] == 128
        _assert_weights_close(group.learner.get_weights(),
                              single.learner.get_weights(), rtol=1e-4,
                              atol=1e-5)
        assert abs(rg["learner/total_loss"] - rs["learner/total_loss"]) < 1e-3
        assert group.learner.num_updates == 1
    finally:
        group.stop()
        single.stop()
    with pytest.raises(RuntimeError, match="closed"):
        group.learner.get_weights()


def _optax_types(tree):
    """A state with the port's optax look-alikes as optax's own types."""
    if isinstance(tree, dict):
        return {k: _optax_types(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_optax_types(v) for v in tree]
        return getattr(optax, type(tree).__name__)(*items) \
            if hasattr(tree, "_fields") else tuple(items)
    return tree


def test_ppo_with_a_learner_mesh_saves_and_restores():
    group, single = _ppo_cfg(MeshConfig(data=2)).build(), _ppo_cfg().build()
    try:
        group.train()
        saved = group.save()
        adam = saved.to_dict()["learner_state"]["opt_state"][1][0]
        assert type(adam) is convert.ScaleByAdamState
        weights = group.learner.get_weights()
        single.restore(saved)
        _assert_weights_close(single.learner.get_weights(), weights, 0, 0)
        one_device = single.save().to_dict()
        for state in (one_device["learner_state"],
                      _optax_types(one_device["learner_state"])):
            group.train()
            group.restore(Checkpoint.from_dict(dict(one_device,
                                                    learner_state=state)))
            _assert_weights_close(group.learner.get_weights(), weights, 0, 0)
            got = group.save().to_dict()["learner_state"]["opt_state"][1][0]
            assert int(got.count) == int(adam.count)
        assert group.learner.gang.run(
            rank_bodies.imported, ("jax", "optax")) == [[], []]
    finally:
        group.stop()
        single.stop()


def test_rank_gang_keeps_state_and_fails_on_a_hung_rank(tmp_path):
    with RankGang(2, device="cpu", init_dir=str(tmp_path),
                  timeout_s=20) as gang:
        assert gang.call(rank_bodies.gang_keep, "a") == [None, None]
        assert gang.call(rank_bodies.gang_keep, "b") == ["a", "a"]
        gang.timeout_s = 3
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="had not finished after 3"):
            gang.call(rank_bodies.gang_stall, 1)
        assert time.monotonic() - t0 < 3 + 5
        with pytest.raises(RuntimeError, match="closed"):
            gang.call(rank_bodies.gang_keep, "c")


def test_rank_gang_fails_on_a_rank_that_raises(tmp_path):
    with RankGang(2, device="cpu", init_dir=str(tmp_path),
                  timeout_s=60) as gang:
        with pytest.raises(RuntimeError, match=r"rank \d raised"):
            gang.call(rank_bodies.gang_keep)            # no value
        with pytest.raises(RuntimeError, match="closed"):
            gang.call(rank_bodies.gang_keep, "c")


def test_learner_mesh_refuses_model_axes():
    for mesh in (MeshConfig(data=2, tensor=2),
                 types.SimpleNamespace(shape={"data": 4, "tensor": 2})):
        with pytest.raises(ValueError, match="data-parallel only"):
            PPOConfig().resources(learner_mesh=mesh)
    mesh = types.SimpleNamespace(shape={"data": 4, "tensor": 2})
    with pytest.raises(ValueError, match="data-parallel only"):
        TorchLearner(6, 3, loss_fn=ppo_loss, config={}, mesh=mesh,
                     device="cpu")
    with pytest.raises(ValueError, match="data-parallel only"):
        _VTraceLearner(4, 2, IMPALAConfig(), (32,), 3, mesh=mesh,
                       device="cpu")

