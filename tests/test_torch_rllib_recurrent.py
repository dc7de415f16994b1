"""The port's recurrent RL (ray_tpu_torch/rllib/) against the reference's
(ray_tpu/rllib/), on the CPU at small widths (hidden (16,), lstm 8-16,
T <= 8):

- RepeatPrev-v0 gives the reference's episodes bit for bit;
- the recurrent actor-critic's `step` and `apply_seq` give the
  reference's within 1e-5 on the same weights (carried by `convert`, bit
  for bit both ways), with resets mid-sequence; a cell without the
  forget gate's +1, or with its gates in another order, misses; cuDNN's
  `nn.LSTM` on the same weights misses unless its second bias carries
  the +1;
- `ppo_loss_recurrent` and every gradient against `jax.value_and_grad`;
  three `TorchLearner(model="lstm")` updates against `JaxLearner`'s by
  update at 0.05 * lr; the recurrent V-trace learner (IMPALA and APPO's
  clipped surrogate): loss, gradients and three updates likewise;
- the recurrent policy's greedy actions and state exactly / within 1e-5,
  the log-probs of its own draws; the rollout layouts (sequence-major
  [B, T] with state_in [B, 2, H], and time-major with bootstrap_state)
  and the resets equal to the reference worker's;
- PPO with use_lstm trains with device="cpu";
- the feed-forward half of the reference's memory gate: on RepeatPrev-v0
  a feed-forward policy stays at chance (< 26 of 48) on the gate's own
  budget.  The LSTM half (> 40 of 48) takes ~25 s here, so it is held on
  the card (`chip_smoke.py` rl_recurrent).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import env as jenv
from ray_tpu.rllib.appo import APPOConfig as JAPPOConfig
from ray_tpu.rllib.impala import IMPALAConfig as JIMPALAConfig
from ray_tpu.rllib.impala import _VTraceLearner as JVTraceLearner
from ray_tpu.rllib.learner import JaxLearner
from ray_tpu.rllib.learner import ppo_loss_recurrent as jppo_recurrent
from ray_tpu.rllib.models import make_recurrent_model as jmake_recurrent
from ray_tpu.rllib.policy import RecurrentJaxPolicy
from ray_tpu.rllib.rollout_worker import RolloutWorker as JRolloutWorker
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import (APPOConfig, IMPALAConfig, PPOConfig,
                                 RecurrentTorchPolicy, RolloutWorker,
                                 SampleBatch, TorchLearner,
                                 make_recurrent_model, ppo_loss,
                                 ppo_loss_recurrent)
from ray_tpu_torch.rllib import env as penv
from ray_tpu_torch.rllib import models as pmodels
from ray_tpu_torch.rllib.impala import _VTraceLearner
from tests.test_torch_rllib import (PPO_CFG, _assert_trees_close,
                                    _capture_grads, _grads, _leaves, _np,
                                    _tensors)
from tests.test_torch_rllib_continuous import as_optax

torch.set_num_threads(1)

HIDDEN = (16,)
LSTM = 8
RTOL = 1e-5


def _recurrent(seed=0, obs_dim=3, num_actions=3):
    """The reference's recurrent params and functions, and the port's
    model on the same weights."""
    init, step, seq, initial = jmake_recurrent(obs_dim, num_actions, HIDDEN,
                                               LSTM)
    params = _np(init(jax.random.key(seed)))
    # Non-zero LSTM biases, so the forget gate's +1 and the gate order
    # meet non-trivial pre-activations.
    params["lstm"]["b"] = np.random.default_rng(seed).normal(
        0, 0.5, 4 * LSTM).astype(np.float32)
    m = make_recurrent_model(obs_dim, num_actions, HIDDEN, LSTM,
                             device="cpu")
    m.load_state_dict(convert.actor_critic_state_dict(params, m))
    return params, step, seq, initial, m


def _sequence(rng, T=8, B=5, obs_dim=3):
    obs = rng.normal(size=(T, B, obs_dim)).astype(np.float32)
    state = rng.normal(0, 0.5, size=(2, B, LSTM)).astype(np.float32)
    resets = np.zeros((T, B), bool)
    resets[3, 1] = resets[5, [0, 4]] = True
    return obs, state, resets


def _seq_err(m, params, seq, obs, state, resets):
    logits, values = m.apply_seq(torch.from_numpy(obs),
                                 torch.from_numpy(state),
                                 torch.from_numpy(resets))
    jl, jv = seq(params, obs, state, resets)
    return max(float(np.abs(logits.detach().numpy() - np.asarray(jl)).max()
                     / np.abs(np.asarray(jl)).max()),
               float(np.abs(values.detach().numpy() - np.asarray(jv)).max()
                     / np.abs(np.asarray(jv)).max()))


# ------------------------------------------------------------------ env

def test_repeat_prev_gives_the_references_episodes():
    ref = jenv.make_vector_env("RepeatPrev-v0", 6, seed=2)
    port = penv.make_vector_env("RepeatPrev-v0", 6, seed=2)
    np.testing.assert_array_equal(ref.reset_all(2), port.reset_all(2))
    rng = np.random.default_rng(0)
    for _ in range(110):              # past two 48-step truncations
        a = rng.integers(0, 3, size=6)
        for x, y in zip(ref.step(a), port.step(a)):
            np.testing.assert_array_equal(x, y)
    rets = ref.drain_episode_metrics()
    assert rets[0] and rets == port.drain_episode_metrics()


# --------------------------------------------------------------- models

def test_recurrent_model_matches_the_reference_with_resets():
    rng = np.random.default_rng(1)
    params, step, seq, _, m = _recurrent(seed=3)
    obs, state, resets = _sequence(rng)
    assert _seq_err(m, params, seq, obs, state, resets) <= RTOL
    # One step, state out included.
    lg, v, s = m.step(torch.from_numpy(obs[0]), torch.from_numpy(state))
    jlg, jv, js = step(params, obs[0], state)
    for a, b in ((lg, jlg), (v, jv), (s, js)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=RTOL, atol=1e-7)
    # A reset zeroes the carry before its step: from t = 5 on, env 0 is a
    # fresh run of the suffix.
    lr_, _ = m.apply_seq(torch.from_numpy(obs), torch.from_numpy(state),
                         torch.from_numpy(resets))
    fresh, _ = m.apply_seq(torch.from_numpy(obs[5:, :1]),
                           torch.zeros(2, 1, LSTM),
                           torch.zeros(3, 1, dtype=torch.bool))
    np.testing.assert_allclose(lr_[5:, :1].detach().numpy(),
                               fresh.detach().numpy(), rtol=1e-6, atol=1e-7)
    # The weights round-trip bit for bit, in the reference's dict.
    got = convert.actor_critic_variables(m)
    assert sorted(got) == ["enc", "lstm", "pi", "vf"]
    assert len(got["enc"]) == len(HIDDEN)
    for a, b in zip(_leaves(got), _leaves(params)):
        np.testing.assert_array_equal(a, b)


def _no_forget_bias(z, c):
    i, f, g, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _ifog_order(z, c):
    i, f, o, g = z.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


@pytest.mark.parametrize("wrong", [_no_forget_bias, _ifog_order],
                         ids=["no_forget_plus_one", "i_f_o_g_order"])
def test_the_cells_forget_bias_and_gate_order_matter(wrong, monkeypatch):
    rng = np.random.default_rng(2)
    params, _, seq, _, m = _recurrent(seed=4)
    obs, state, resets = _sequence(rng)
    assert _seq_err(m, params, seq, obs, state, resets) <= RTOL
    monkeypatch.setattr(pmodels, "lstm_gates", wrong)
    assert _seq_err(m, params, seq, obs, state, resets) > 1e-3


def test_cudnn_style_lstm_needs_the_plus_one_in_its_second_bias():
    """nn.LSTM orders its gates i/f/g/o too, but adds two biases and no
    +1: on the reference's weights (wx, wh transposed, b as bias_ih) it
    misses the reference's cell until bias_hh carries +1 on the forget
    gate's quarter.  It cannot zero the carry mid-sequence, so this runs
    without resets."""
    rng = np.random.default_rng(3)
    params, _, seq, _, m = _recurrent(seed=5)
    obs, state, _ = _sequence(rng)
    no_resets = np.zeros(obs.shape[:2], bool)
    jl, _ = seq(params, obs, state, no_resets)
    lstm = torch.nn.LSTM(HIDDEN[-1], LSTM)
    x = torch.from_numpy(obs)
    for layer in m.enc:
        x = torch.tanh(layer(x))
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(m.lstm.wx.t())
        lstm.weight_hh_l0.copy_(m.lstm.wh.t())
        lstm.bias_ih_l0.copy_(m.lstm.b)
        lstm.bias_hh_l0.zero_()

    def err():
        with torch.no_grad():
            hs, _ = lstm(x, (torch.from_numpy(state[0])[None],
                             torch.from_numpy(state[1])[None]))
            return float(np.abs(m.pi(hs).numpy() - np.asarray(jl)).max())

    assert err() > 1e-4
    with torch.no_grad():
        lstm.bias_hh_l0[LSTM:2 * LSTM] = 1.0
    assert err() <= 1e-6


# --------------------------------------------------------------- PPO

def _seq_batch(rng, b=6, T=8, obs_dim=3, num_actions=3):
    resets = rng.random((b, T)) < 0.15
    return SampleBatch({
        SampleBatch.OBS: rng.normal(size=(b, T, obs_dim)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, num_actions, (b, T)).astype(
            np.int32),
        SampleBatch.ACTION_LOGP: rng.uniform(-1.6, -0.6, (b, T)).astype(
            np.float32),
        SampleBatch.VF_PREDS: rng.normal(size=(b, T)).astype(np.float32),
        SampleBatch.ADVANTAGES: rng.normal(size=(b, T)).astype(np.float32),
        SampleBatch.VALUE_TARGETS: (2 * rng.normal(size=(b, T))).astype(
            np.float32),
        "resets": resets,
        "state_in": rng.normal(0, 0.3, (b, 2, LSTM)).astype(np.float32),
    })


def test_ppo_loss_recurrent_and_gradients_match_jax():
    rng = np.random.default_rng(4)
    params, _, seq, _, m = _recurrent(seed=6)
    mb = _seq_batch(rng)
    cfg = dict(PPO_CFG, entropy_coeff=0.01)
    (jloss, jmet), jgrads = jax.value_and_grad(
        functools.partial(jppo_recurrent, seq), has_aux=True)(
            params, {k: jnp.asarray(v) for k, v in mb.items()}, cfg)
    loss, met = ppo_loss_recurrent(m, _tensors(mb), cfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    for k in jmet:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]),
                                   rtol=RTOL, atol=1e-6)
    grads = convert.actor_critic_variables(_grads(m, loss))
    _assert_trees_close(grads, jgrads, rtol=1e-4, atol=1e-7)


def _lstm_learners(lr, seed=3):
    cfg = dict(PPO_CFG, lr=lr, grad_clip=0.5, num_sgd_iter=1,
               sgd_minibatch_size=6)
    kw = dict(loss_fn=None, config=cfg, hidden=HIDDEN, seed=seed,
              model="lstm", lstm_size=LSTM)
    ref = JaxLearner(3, 3, **dict(kw, loss_fn=jppo_recurrent))
    port = TorchLearner(3, 3, device="cpu",
                        **dict(kw, loss_fn=ppo_loss_recurrent))
    port.set_state(_np(ref.get_state()))
    return ref, port


def _updates_close(ref, port, batch, lr, rtol=RTOL):
    before_r, before_p = ref.get_weights(), port.get_weights()
    rm, pm = ref.update(batch), port.update(batch)
    np.testing.assert_allclose(pm["total_loss"], rm["total_loss"], rtol=rtol)
    for pb, pa, rb, ra in zip(_leaves(before_p), _leaves(port.get_weights()),
                              _leaves(before_r), _leaves(ref.get_weights())):
        np.testing.assert_allclose(pa - pb, ra - rb, rtol=0, atol=0.05 * lr)


def test_lstm_learner_updates_match_jax_and_cross_both_ways():
    """Three updates over one minibatch of sequences, by update; then the
    port's state restored into a fresh reference learner (bit for bit)
    and its next update the port's."""
    rng = np.random.default_rng(5)
    lr = 1e-2
    ref, port = _lstm_learners(lr)
    for step in range(3):
        batch = _seq_batch(rng)
        batch[SampleBatch.ADVANTAGES] *= 1 + 2 * step
        _updates_close(ref, port, batch, lr)
    ref2, _ = _lstm_learners(lr, seed=9)
    ref2.set_state(as_optax(port.get_state()))
    for a, b in zip(_leaves(ref2.get_state()), _leaves(port.get_state())):
        np.testing.assert_array_equal(a, b)
    _updates_close(ref2, port, _seq_batch(rng), lr)


# -------------------------------------------------------- V-trace, APPO

def _recurrent_fragment(rng, T=8, B=4, obs_dim=3):
    term = np.zeros((T, B), bool)
    trunc = np.zeros((T, B), bool)
    term[2, 0] = trunc[5, 3] = True
    resets = np.zeros((T, B), bool)
    resets[3, 0] = resets[6, 3] = True
    return SampleBatch({
        SampleBatch.OBS: rng.normal(size=(T, B, obs_dim)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, 3, (T, B)).astype(np.int32),
        SampleBatch.ACTION_LOGP: rng.uniform(-1.6, -0.6, (T, B)).astype(
            np.float32),
        SampleBatch.REWARDS: rng.normal(size=(T, B)).astype(np.float32),
        SampleBatch.TERMINATEDS: term, SampleBatch.TRUNCATEDS: trunc,
        "state_in": rng.normal(0, 0.3, (2, B, LSTM)).astype(np.float32),
        "resets": resets,
        "bootstrap_obs": rng.normal(size=(B, obs_dim)).astype(np.float32),
        "bootstrap_state": rng.normal(0, 0.3, (2, B, LSTM)).astype(
            np.float32),
    })


def _vtrace_cfgs(kind, lr):
    out = []
    for cls in ((JIMPALAConfig, IMPALAConfig) if kind == "impala"
                else (JAPPOConfig, APPOConfig)):
        cfg = cls()
        cfg.lr, cfg.grad_clip = lr, 1.0
        cfg.use_lstm, cfg.lstm_size = True, LSTM
        out.append(cfg)
    return out


@pytest.mark.parametrize("kind", ["impala", "appo"])
def test_recurrent_vtrace_learner_matches_reference(kind):
    rng = np.random.default_rng(6)
    lr = 5e-3
    jcfg, pcfg = _vtrace_cfgs(kind, lr)
    ref = JVTraceLearner(3, 3, jcfg, HIDDEN, seed=4)
    port = _VTraceLearner(3, 3, pcfg, HIDDEN, seed=4, device="cpu")
    port.set_state(_np(ref.get_state()))
    batches = [_recurrent_fragment(rng) for _ in range(3)]
    grab = JVTraceLearner(3, 3, jcfg, HIDDEN, seed=4)
    grab.tx = _capture_grads()
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    _, jgrads, jmet = grab._step(ref.params, grab.tx.init(ref.params), jb)
    loss, met = port.loss(_tensors(batches[0]))
    for k in jmet:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]),
                                   rtol=RTOL, atol=1e-6)
    grads = convert.actor_critic_variables(_grads(port.model, loss))
    _assert_trees_close(grads, jgrads, rtol=1e-4, atol=1e-7)
    for batch in batches:
        _updates_close(ref, port, batch, lr, rtol=1e-4)
    assert port.num_updates == ref.num_updates == 3


# -------------------------------------------------------------- policy

def test_recurrent_policy_greedy_state_and_logps():
    rng = np.random.default_rng(7)
    jp = RecurrentJaxPolicy(3, 3, HIDDEN, LSTM, seed=0)
    pp = RecurrentTorchPolicy(3, 3, HIDDEN, LSTM, seed=0, device="cpu")
    pp.set_weights(jp.get_weights())
    state_j = state_p = jp.initial_state(32)
    for _ in range(4):
        x = rng.normal(size=(32, 3)).astype(np.float32)
        ja, _, jv, jl, state_j = jp.compute_actions(x, state_j, False)
        pa, plp, pv, pl, state_p = pp.compute_actions(x, state_p, False)
        np.testing.assert_array_equal(pa, ja)
        assert (plp == 0).all()
        np.testing.assert_allclose(pv, jv, rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(state_p, np.asarray(state_j), rtol=RTOL,
                                   atol=1e-6)
    assert state_p.flags.writeable
    a, logp, _, logits, _ = pp.compute_actions(x, state_p)
    want = np.asarray(jax.nn.log_softmax(logits))[np.arange(32), a]
    np.testing.assert_allclose(logp, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("postprocess", [True, False])
def test_recurrent_rollout_layouts_and_resets(postprocess):
    """The reference worker's columns, shapes and dtypes; the obs, rewards
    and resets of the same episodes (10-step fragments cross RepeatPrev's
    48-step truncation at step 8 of the fifth fragment)."""
    kw = dict(num_envs=4, rollout_fragment_length=10, hidden=HIDDEN,
              lstm_size=LSTM, policy_kind="recurrent", seed=1,
              postprocess=postprocess)
    ref = JRolloutWorker("RepeatPrev-v0", **kw)
    port = RolloutWorker("RepeatPrev-v0", device="cpu", **kw)
    port.set_weights(ref.get_weights())
    seen_reset = False
    for _ in range(6):
        rb, _ = ref.sample()
        pb, _ = port.sample()
        assert {k: (v.shape, v.dtype) for k, v in pb.items()} == \
            {k: (v.shape, v.dtype) for k, v in rb.items()}
        np.testing.assert_array_equal(pb["resets"], rb["resets"])
        np.testing.assert_array_equal(pb[SampleBatch.OBS][:, :1],
                                      rb[SampleBatch.OBS][:, :1])
        seen_reset |= bool(pb["resets"].any())
    assert seen_reset
    if postprocess:
        assert pb[SampleBatch.OBS].shape == (4, 10, 3)        # [B, T, D]
        assert pb["state_in"].shape == (4, 2, LSTM)
    else:
        assert pb["state_in"].shape == pb["bootstrap_state"].shape == \
            (2, 4, LSTM)
        # The next fragment starts from this one's bootstrap state.
        nb, _ = port.sample()
        np.testing.assert_array_equal(nb["state_in"], pb["bootstrap_state"])


# -------------------------------------------------------------- drivers

def test_ppo_with_lstm_trains_on_sequences():
    cfg = (PPOConfig().environment("RepeatPrev-v0")
           .rollouts(num_rollout_workers=0, num_envs_per_worker=8,
                     rollout_fragment_length=16)
           .training(train_batch_size=8, sgd_minibatch_size=8,
                     num_sgd_iter=2, use_lstm=True, lstm_size=16,
                     model_hidden=HIDDEN)
           .resources(device="cpu", rollout_device="cpu"))
    algo = cfg.build()
    try:
        r = algo.train()
        assert r["sampled_rows"] == 8                  # sequences
        assert np.isfinite(r["learner/total_loss"])
        assert algo.learner.opt.count == 2
        batch, _ = algo.workers.local_worker.sample()
        assert batch["state_in"].shape == (8, 2, 16)
    finally:
        algo.stop()


def test_feed_forward_policy_stays_at_chance_on_the_memory_task():
    """The reference's gate (tests/test_rllib.py
    test_recurrent_ppo_solves_memory_task_feedforward_cannot), its
    feed-forward half at its own settings: the current symbol says
    nothing about the rewarded action, so 120 iterations leave the policy
    at chance (16 of 48), below 26."""
    w = RolloutWorker("RepeatPrev-v0", num_envs=32,
                      rollout_fragment_length=24, hidden=(32,), seed=0,
                      gamma=0.5, lam=0.9, device="cpu")
    ln = TorchLearner(3, 3, hidden=(32,), loss_fn=ppo_loss,
                      config={"lr": 5e-3, "num_sgd_iter": 8,
                              "sgd_minibatch_size": 256,
                              "entropy_coeff": 0.01}, device="cpu")
    for _ in range(120):
        w.set_weights(ln.get_weights())
        b, _ = w.sample()
        ln.update(b)
    rets = []
    for _ in range(4):
        _, m = w.sample()
        rets += m["episode_returns"]
    assert rets and sum(rets) / len(rets) < 26
