"""The port's offline RL (ray_tpu_torch/rllib/: offline.py, marwil.py,
cql.py, estimators.py) against the reference's (ray_tpu/rllib/), on the
CPU at small widths:

- JSON experience files: the two writers write the same bytes, and each
  package reads what the other wrote; Parquet files from both writers
  stream through `DatasetReader` over a `ray_tpu.data` dataset (the
  runtime handle) into BC, which recovers the expert;
- BC's, MARWIL's and CQL's losses and every gradient against the
  reference's at the reference's initial weights (1e-5 relative), and a
  `train_on` of several minibatches by update at 0.05 * lr; MARWIL's
  running advantage moment after two calls (1e-5 relative); CQL's
  refusals of a ragged batch and of a `next_obs` of another row count;
  CQL's target moving only at its sync (an alias, the reference's own
  idiom, fails that check in the port);
- `compute_mc_returns`, `split_episodes` and IS / WIS / DM / DR equal to
  the reference's exactly on the same batch, and their closed forms;
  `fit_fqe`'s Q-values after 20 iterations from the reference's initial
  weights within 1e-4 relative + 1e-4;
- the reference's offline gates with the port: BC above 0.95 agreement,
  MARWIL at beta 2 above 0.9 and at beta 0 below 0.5, CQL conservative.
"""

import os

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.data  # noqa: F401  (the handle's Data layer: ray_tpu.data)
from ray_tpu.rllib import cql as jcql
from ray_tpu.rllib import estimators as jest
from ray_tpu.rllib import marwil as jmarwil
from ray_tpu.rllib import offline as joffline
from ray_tpu.rllib.models import make_model as jmake_model
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import (BC, CQL, MARWIL, BCConfig, CQLConfig,
                                 MARWILConfig, SampleBatch)
from ray_tpu_torch.rllib import cql as pcql
from ray_tpu_torch.rllib import estimators as pest
from ray_tpu_torch.rllib import marwil as pmarwil
from ray_tpu_torch.rllib import offline as poffline
from tests.test_rllib_offline_eval import (GAMMA, V_TRUE, _enumerated_batch,
                                           _exact_q, _mixed_quality_log,
                                           _target_probs)
from tests.test_torch_rllib import _capture_grads, _leaves, _np

torch.set_num_threads(1)

HIDDEN = (32, 32)
RTOL = 1e-5


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu.init(num_cpus=2, object_store_memory=64 << 20)
    yield info
    ray_tpu.shutdown()


def _expert_batch(rng, n=16):
    obs = rng.uniform(-0.2, 0.2, size=(n, 4)).astype(np.float32)
    return SampleBatch({SampleBatch.OBS: obs,
                        SampleBatch.ACTIONS: (obs[:, 2] > 0).astype(
                            np.int64)})


def _expert_agreement(learner, rng) -> float:
    test_obs = rng.uniform(-0.2, 0.2, size=(200, 4)).astype(np.float32)
    return float((learner.compute_actions(test_obs)
                  == (test_obs[:, 2] > 0)).mean())


# ------------------------------------------------------------------ IO

def _mixed_batch(rng, n=12):
    return SampleBatch({
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 3, n).astype(np.int64),
        "rewards": rng.normal(size=n).astype(np.float32),
        "terminateds": rng.random(n) < 0.2,
        "frames": rng.integers(0, 255, (n, 2, 3)).astype(np.uint8)})


def test_json_files_are_the_references_and_cross_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    batches = [_mixed_batch(rng) for _ in range(5)]
    for mod, name in ((joffline, "ref"), (poffline, "port")):
        w = mod.JsonWriter(str(tmp_path / name), max_file_size=2000)
        for b in batches:
            w.write(b)
        w.close()
    ref_files = sorted(os.listdir(tmp_path / "ref"))
    assert len(ref_files) > 1                     # rotated past 2,000 B
    assert sorted(os.listdir(tmp_path / "port")) == ref_files
    for f in ref_files:
        assert (tmp_path / "ref" / f).read_bytes() == \
            (tmp_path / "port" / f).read_bytes()
    # Each package reads the other's files back bit for bit.
    for reader, src in ((poffline.JsonReader, "ref"),
                        (joffline.JsonReader, "port")):
        got = list(reader(str(tmp_path / src)))
        assert len(got) == len(batches)
        for g, b in zip(got, batches):
            assert set(g) == set(b)
            for k in b:
                assert g[k].dtype == b[k].dtype
                np.testing.assert_array_equal(g[k], b[k])


def test_json_dataset_and_bc_recover_the_expert(cluster, tmp_path):
    """The reference's BC gate (tests/test_rllib.py) with the port: 640
    logged expert rows written and read back, a dataset built through
    the runtime handle, 30 train_on calls, agreement above 0.95."""
    rng = np.random.default_rng(0)
    writer = poffline.JsonWriter(str(tmp_path / "exp"))
    for _ in range(40):
        writer.write(_expert_batch(rng))
    writer.close()
    reader = poffline.JsonReader(str(tmp_path / "exp"))
    all_exp = reader.read_all()
    assert all_exp.count == 640 and all_exp["obs"].shape == (640, 4)
    assert reader.to_dataset(ray_tpu).count() == 640
    bc = BC(4, 2, BCConfig(), device="cpu")
    for _ in range(30):
        metrics = bc.train_on(all_exp)
    assert metrics["samples"] == 640
    assert _expert_agreement(bc, rng) > 0.95


def test_parquet_from_both_writers_streams_into_bc(cluster, tmp_path):
    """Both writers' Parquet files read through the port's DatasetReader
    (`runtime.data.read_parquet`) equal the reference's reader's
    batches; streaming them into the port's BC for 15 epochs recovers
    the expert (the reference's test_bc_trains_from_parquet_dataset)."""
    rng = np.random.default_rng(1)
    batches = [_expert_batch(rng, 64) for _ in range(10)]
    for mod, name in ((joffline, "ref"), (poffline, "port")):
        w = mod.ParquetWriter(str(tmp_path / name))
        for b in batches:
            w.write(b)
        w.close()
    port_ref = poffline.DatasetReader.from_path(
        str(tmp_path / "ref"), batch_size=128, runtime=ray_tpu).read_all()
    port_port = poffline.DatasetReader.from_path(
        str(tmp_path / "port"), batch_size=128, runtime=ray_tpu).read_all()
    ref_ref = joffline.DatasetReader.from_path(
        str(tmp_path / "ref"), batch_size=128).read_all()
    for got in (port_ref, port_port):
        assert got.count == 640
        for k in ref_ref:
            np.testing.assert_array_equal(got[k], ref_ref[k])
    reader = poffline.DatasetReader.from_path(
        str(tmp_path / "port"), batch_size=128, runtime=ray_tpu)
    bc = BC(4, 2, BCConfig(), device="cpu")
    for _ in range(15):
        for minibatch in reader:
            assert minibatch.count <= 128
            metrics = bc.train_on(minibatch)
    assert metrics["samples"] <= 128
    assert _expert_agreement(bc, rng) > 0.95


# ------------------------------------------- BC, MARWIL, CQL by update

def _load(port, variables):
    port.model.load_state_dict(convert.actor_critic_state_dict(
        variables, port.model))


def _carry(ref, port):
    """The reference learner's initial weights into the port's (CQL's
    target too: the reference's starts as its initial network)."""
    _load(port, _np(ref.params))
    if hasattr(port, "target"):
        port.sync_target()
    for a, b in zip(_leaves(port.get_weights()), _leaves(ref.params)):
        np.testing.assert_array_equal(a, b)


def _port_grads(port, loss):
    names = [n for n, _ in port.model.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.model.parameters()),
                                materialize_grads=True)
    return convert.actor_critic_variables(dict(zip(names, grads)))


def _offline_log(rng, n=200, obs_dim=4, num_actions=3):
    return SampleBatch({
        "obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, num_actions, n).astype(np.int64),
        "rewards": rng.normal(size=n).astype(np.float32),
        "terminateds": rng.random(n) < 0.1})


def _cfgs(name, lr):
    jcls, pcls = {"bc": (joffline.BCConfig, BCConfig),
                  "marwil": (jmarwil.MARWILConfig, MARWILConfig),
                  "cql": (jcql.CQLConfig, CQLConfig)}[name]
    out = []
    for cls in (jcls, pcls):
        cfg = cls()
        cfg.lr, cfg.model_hidden, cfg.seed = lr, HIDDEN, 4
        cfg.train_batch_size = 64
        if name == "marwil":
            cfg.beta = 1.5
        if name == "cql":
            cfg.target_update_interval = 2
        out.append(cfg)
    return out


def _pair(name, lr):
    jcfg, pcfg = _cfgs(name, lr)
    jcls, pcls = {"bc": (joffline.BC, BC), "marwil": (jmarwil.MARWIL, MARWIL),
                  "cql": (jcql.CQL, CQL)}[name]
    ref, port = jcls(4, 3, jcfg), pcls(4, 3, pcfg, device="cpu")
    _carry(ref, port)
    return ref, port


def _ref_step_args(name, ref, cols, c=None):
    obs, acts, rews, next_obs, dones, rets = cols
    if name == "bc":
        return (ref.params, ref.opt_state, obs, acts)
    if name == "marwil":
        return (ref.params, ref.opt_state, obs, acts, rets, c)
    return (ref.params, ref.target_params, ref.opt_state, obs, acts, rews,
            next_obs, dones)


def _cols(rng, n=64):
    obs = rng.normal(size=(n, 4)).astype(np.float32)
    return (obs, rng.integers(0, 3, n).astype(np.int64),
            rng.normal(size=n).astype(np.float32),
            rng.normal(size=(n, 4)).astype(np.float32),
            (rng.random(n) < 0.2).astype(np.float32),
            (3 * rng.normal(size=n)).astype(np.float32))


@pytest.mark.parametrize("name", ["bc", "marwil", "cql"])
def test_loss_and_gradients_match_the_reference(name):
    rng = np.random.default_rng(2)
    ref, port = _pair(name, 1e-2)
    if name == "cql":             # a target other than the network
        other = _cfgs("cql", 1e-2)[0]
        other.seed = 9
        ref.target_params = _np(jcql.CQL(4, 3, other).params)
        port.target.load_state_dict(convert.actor_critic_state_dict(
            ref.target_params, port.target))
    grab = {"bc": joffline.BC, "marwil": jmarwil.MARWIL,
            "cql": jcql.CQL}[name](4, 3, _cfgs(name, 1e-2)[0])
    grab.tx = _capture_grads()          # read before the first trace
    grab.params = ref.params
    grab.opt_state = grab.tx.init(ref.params)
    if name == "cql":
        grab.target_params = ref.target_params
    cols = _cols(rng)
    c = 1.7
    # (params, captured gradients, loss[, aux])
    out = grab._step(*_ref_step_args(name, grab, cols, c))
    jgrads, jloss = out[1], out[2]
    t = [torch.from_numpy(x) for x in cols]
    if name == "bc":
        loss = port.loss(t[0], t[1])
        parts = []
    elif name == "marwil":
        loss, pl, vf, adv = port.loss(t[0], t[1], t[5], c)
        parts = [(pl, out[3][0]), (vf, out[3][1]), (adv, out[3][2])]
    else:
        loss, td, cons = port.loss(t[0], t[1], t[2], t[3], t[4])
        parts = [(td, out[3][0]), (cons, out[3][1])]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    for got, want in parts:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-6)
    grads = _port_grads(port, loss)
    for a, b in zip(_leaves(grads), _leaves(jgrads)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-7)


def _train_both(name, ref, port, batch, lr):
    before_r, before_p = _leaves(ref.params), _leaves(port.get_weights())
    rm, pm = ref.train_on(batch), port.train_on(batch)
    assert set(pm) == set(rm) and pm["samples"] == rm["samples"]
    for k in rm:
        np.testing.assert_allclose(pm[k], rm[k], rtol=1e-4, atol=1e-6)
    for pb, pa, rb, ra in zip(before_p, _leaves(port.get_weights()),
                              before_r, _leaves(ref.params)):
        np.testing.assert_allclose(pa - pb, ra - rb, rtol=0, atol=0.05 * lr)


@pytest.mark.parametrize("name", ["bc", "marwil", "cql"])
def test_train_on_matches_the_reference_by_update(name):
    """A train_on of 200 rows in minibatches of 64 (4 steps, the same
    numpy permutation on both sides; CQL syncs its target every 2),
    twice: the metrics within 1e-4 relative, every weight by update at
    0.05 * lr; MARWIL's advantage moment within 1e-5 relative."""
    rng = np.random.default_rng(3)
    lr = 1e-2
    ref, port = _pair(name, lr)
    batch = _offline_log(rng)
    for _ in range(2):
        _train_both(name, ref, port, batch, lr)
    if name == "marwil":
        assert port.adv_norm_sq != 1.0
        np.testing.assert_allclose(port.adv_norm_sq, ref.adv_norm_sq,
                                   rtol=RTOL)
    if name == "cql":
        assert port._steps == ref._steps == 8
        for a, b in zip(_leaves(convert.actor_critic_variables(port.target)),
                        _leaves(ref.target_params)):
            np.testing.assert_allclose(a, b, rtol=0, atol=0.05 * lr)


def test_time_major_fragments_flatten_to_rows():
    """[T, B] fragments train as T * B rows in both packages."""
    rng = np.random.default_rng(4)
    frag = SampleBatch({
        "obs": rng.normal(size=(5, 8, 4)).astype(np.float32),
        "actions": rng.integers(0, 3, (5, 8)).astype(np.int64),
        "rewards": rng.normal(size=(5, 8)).astype(np.float32),
        "terminateds": rng.random((5, 8)) < 0.2,
        "truncateds": np.zeros((5, 8), bool)})
    for name in ("bc", "marwil"):
        ref, port = _pair(name, 1e-2)
        _train_both(name, ref, port, frag, 1e-2)
        assert port.train_on(frag)["samples"] == 40


@pytest.mark.parametrize("mod", [jcql, pcql], ids=["reference", "port"])
def test_cql_refuses_ragged_batches_and_a_short_next_obs(mod):
    rng = np.random.default_rng(5)
    cfg = mod.CQLConfig()
    cfg.model_hidden = HIDDEN
    algo = (mod.CQL(4, 3, cfg) if mod is jcql
            else mod.CQL(4, 3, cfg, device="cpu"))
    batch = _offline_log(rng, n=10)
    ragged = SampleBatch(dict(batch, rewards=batch["rewards"][:7]))
    with pytest.raises(ValueError, match="ragged batch"):
        algo.train_on(ragged)
    short = SampleBatch(dict(batch, next_obs=batch["obs"][:9]))
    with pytest.raises(ValueError, match="next_obs rows 9 != obs rows 10"):
        algo.train_on(short)
    with pytest.raises(ValueError, match="empty batch"):
        algo.train_on(SampleBatch({k: v[:0] for k, v in batch.items()}))
    # An explicit next_obs column of the right length trains.
    assert algo.train_on(SampleBatch(dict(
        batch, next_obs=batch["obs"][::-1].copy())))["samples"] == 10


def _cql_target_holds(rng) -> bool:
    """Whether the port's target stays put between syncs and equals the
    network right after one."""
    _, port = _pair("cql", 1e-2)
    port.config.target_update_interval = 1000
    before = _leaves(convert.actor_critic_variables(port.target))
    port.train_on(_offline_log(rng))                   # 4 steps, no sync
    held = all(np.array_equal(a, b) for a, b in zip(
        before, _leaves(convert.actor_critic_variables(port.target))))
    port.sync_target()
    synced = all(np.array_equal(a, b) for a, b in zip(
        _leaves(convert.actor_critic_variables(port.target)),
        _leaves(port.get_weights())))
    return held and synced


def test_cql_target_moves_only_at_its_sync(monkeypatch):
    """The reference's target is the network's arrays (a snapshot under
    JAX's immutability); the port updates in place, so it copies.  The
    copy holds; an alias fails."""
    assert _cql_target_holds(np.random.default_rng(6))
    monkeypatch.setattr(pcql, "frozen_copy", lambda model: model)
    assert not _cql_target_holds(np.random.default_rng(6))


# ------------------------------------------------------------ estimators

def _logged_episodes(rng, n=120):
    obs = rng.normal(size=(n, 3)).astype(np.float32)
    return SampleBatch({
        "obs": obs, "actions": rng.integers(0, 3, n).astype(np.int64),
        "rewards": rng.normal(size=n).astype(np.float32),
        "action_logp": np.log(rng.uniform(0.2, 0.6, n)).astype(np.float32),
        "terminateds": rng.random(n) < 0.08,
        "truncateds": rng.random(n) < 0.03})


def _probs(obs):
    z = np.stack([obs[:, 0], obs[:, 1], 0.5 * obs[:, 2]], -1)
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _q(obs):
    return np.stack([obs.sum(-1), obs[:, 0] ** 2, np.cos(obs[:, 1])], -1)


def test_mc_returns_and_episodes_equal_the_references():
    rng = np.random.default_rng(7)
    batch = _logged_episodes(rng)
    done = batch["terminateds"] | batch["truncateds"]
    np.testing.assert_array_equal(
        pmarwil.compute_mc_returns(batch["rewards"], done, 0.97),
        jmarwil.compute_mc_returns(batch["rewards"], done, 0.97))
    got, want = pest.split_episodes(batch), jest.split_episodes(batch)
    assert len(got) == len(want) > 5
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("key", ["is", "wis", "dm", "dr"])
def test_estimators_equal_the_references(key):
    batch = _logged_episodes(np.random.default_rng(8))
    got = pest.ESTIMATORS[key](_probs, gamma=0.95, q_fn=_q).estimate(batch)
    want = jest.ESTIMATORS[key](_probs, gamma=0.95, q_fn=_q).estimate(batch)
    assert got == want


@pytest.mark.parametrize("key", ["is", "wis", "dm", "dr"])
def test_estimators_hit_the_closed_form(key):
    """The enumerated two-step MDP of tests/test_rllib_offline_eval.py:
    every estimator exact with the exact model, DR also with a wrong
    one."""
    batch = _enumerated_batch()
    for q_fn in ((_exact_q, lambda o: _exact_q(o) + 1.7) if key == "dr"
                 else (_exact_q,)):
        est = pest.ESTIMATORS[key](_target_probs, gamma=GAMMA, q_fn=q_fn)
        out = est.estimate(batch)
        assert out["episodes"] == 4
        assert abs(out["v_target"] - V_TRUE) < 1e-5, out


def test_fit_fqe_matches_the_reference_and_feeds_dm(monkeypatch):
    """20 iterations of each package's fit_fqe from the reference's
    initial weights (hidden (64,), lr 1e-2): Q-values within 1e-4
    relative + 1e-4.  Then the port's FQE at 400 iterations feeds DM to
    within 0.4 of the truth, the reference's gate."""
    batch = SampleBatch.concat_samples([_enumerated_batch()] * 16)
    init, _ = jmake_model(2, 2, (64,))
    variables = _np(init(jax.random.key(0)))
    make = pest.make_model

    def seeded(*args, **kwargs):
        model = make(*args, **kwargs)
        model.load_state_dict(convert.actor_critic_state_dict(variables,
                                                              model))
        return model

    monkeypatch.setattr(pest, "make_model", seeded)
    kw = dict(num_actions=2, gamma=GAMMA, iterations=20)
    got = pest.fit_fqe(batch, _target_probs, device="cpu", **kw)
    want = jest.fit_fqe(batch, _target_probs, **kw)
    obs = np.asarray(batch["obs"])
    np.testing.assert_allclose(got(obs), want(obs), rtol=1e-4, atol=1e-4)
    monkeypatch.undo()
    q_fn = pest.fit_fqe(batch, _target_probs, num_actions=2, gamma=GAMMA,
                        iterations=400, lr=3e-2, hidden=(32,), seed=0,
                        device="cpu")
    out = pest.DirectMethod(_target_probs, gamma=GAMMA,
                            q_fn=q_fn).estimate(batch)
    assert abs(out["v_target"] - V_TRUE) < 0.4, out


# ------------------------------------------------------------- gates

def test_marwil_beats_bc_on_a_mixed_quality_log():
    batch = _mixed_quality_log()
    rng = np.random.default_rng(42)
    test_obs = rng.uniform(-1, 1, (400, 4)).astype(np.float32)
    expert = (test_obs[:, 2] > 0).astype(np.int64)

    def agreement(beta):
        cfg = MARWILConfig()
        cfg.beta, cfg.num_epochs, cfg.seed = beta, 40, 5
        algo = MARWIL(4, 2, cfg, device="cpu")
        algo.train_on(batch)
        return (algo.compute_actions(test_obs) == expert).mean()

    bc_acc, marwil_acc = agreement(0.0), agreement(2.0)
    assert bc_acc < 0.5 and marwil_acc > 0.9, (bc_acc, marwil_acc)


def test_cql_pushes_the_unlogged_action_down():
    rng = np.random.default_rng(3)
    n = 600
    s0 = np.eye(2, dtype=np.float32)[0]
    acts = rng.integers(0, 2, n)
    batch = SampleBatch({
        "obs": np.tile(s0, (n, 1)), "actions": acts.astype(np.int64),
        "rewards": np.where(acts == 0, 1.0, 0.2).astype(np.float32),
        "terminateds": np.ones(n, bool)})

    def train(alpha):
        cfg = CQLConfig()
        cfg.cql_alpha, cfg.num_epochs, cfg.seed = alpha, 30, 7
        algo = CQL(2, 3, cfg, device="cpu")
        algo.train_on(batch)
        return algo.q_values(s0[None, :])[0]

    q, q_td = train(1.0), train(0.0)
    assert q.argmax() == 0 and q[2] < q[1] < q[0], q
    assert (q.max() - q[2]) > (q_td.max() - q_td[2]) + 0.2, (q, q_td)


@pytest.mark.parametrize("hidden", [(64,), (64, 64)])
def test_actor_critic_carries_at_every_offline_width(hidden):
    """BC, MARWIL and CQL run (64, 64) and FQE (64,): the reference's
    weights carry into the port's model and back bit for bit, and the
    logits and values agree within 1e-5."""
    init, apply = jmake_model(4, 3, hidden)
    variables = _np(init(jax.random.key(1)))
    port = BC(4, 3, BCConfig(), device="cpu")
    port.model = poffline.make_model(4, 3, hidden, device="cpu")
    _load(port, variables)
    for a, b in zip(_leaves(port.get_weights()), _leaves(variables)):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(9).normal(size=(16, 4)).astype(np.float32)
    got = port.model(torch.from_numpy(x))
    for a, b in zip(got, apply(variables, x)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=RTOL, atol=1e-6)


def test_bc_takes_a_generator_for_its_weights():
    """The initial weights come from the caller's generator, else from
    one seeded with the config's seed."""
    cfg = BCConfig()
    a = BC(4, 2, cfg, device="cpu").get_weights()
    b = BC(4, 2, cfg, device="cpu",
           generator=torch.Generator().manual_seed(cfg.seed)).get_weights()
    c = BC(4, 2, cfg, device="cpu",
           generator=torch.Generator().manual_seed(99)).get_weights()
    assert all(np.array_equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    assert not all(np.array_equal(x, y)
                   for x, y in zip(_leaves(a), _leaves(c)))

