"""The port's V-trace (ray_tpu_torch/rllib/vtrace.py) against the
reference's (ray_tpu/rllib/vtrace.py), on the CPU:

- random time-major fragments, T from 1 to 64, with terminations, clipped
  (rho_bar = c_bar = 1, and rho_bar != c_bar) and unclipped, against the
  reference's lax.scan within 1e-6 of each output's largest magnitude
  (f32 rounding of exp and of the recursion; unclipped importance
  weights of up to e^3 carry it along the fragment);
- the hand-computed cases of tests/test_vtrace.py restated against the
  port: the T=2 clipped-rho case to the digit, on-policy = n-step
  returns, the per-env python recursion of Espeholt et al. (2018), and a
  zero discount cutting all credit flow;
- no graph: the targets carry no gradient whatever the inputs require.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.vtrace import vtrace as jvtrace
from ray_tpu_torch.rllib.vtrace import vtrace

from tests.test_vtrace import _np_vtrace

TOL = 1e-6


def _fragment(seed, T, B=5):
    rng = np.random.default_rng(seed)
    behavior = rng.normal(size=(T, B)).astype(np.float32)
    target = (behavior + rng.normal(scale=0.8, size=(T, B))).astype(
        np.float32)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    bootstrap = rng.normal(size=B).astype(np.float32)
    dones = rng.random((T, B)) < 0.15
    discounts = (0.99 * (~dones)).astype(np.float32)
    return behavior, target, rewards, discounts, values, bootstrap


def _port(*arrays, **kw):
    out = vtrace(*(torch.from_numpy(a) for a in arrays), **kw)
    return out.vs.numpy(), out.pg_advantages.numpy()


@pytest.mark.parametrize("T", [1, 2, 7, 33, 64])
@pytest.mark.parametrize("rho_bar,c_bar", [(1.0, 1.0), (2.0, 0.9),
                                           (1e9, 1e9)])
def test_vtrace_matches_reference(T, rho_bar, c_bar):
    arrays = _fragment(T * 10 + int(c_bar * 10) % 7, T)
    ref = jvtrace(*(jnp.asarray(a) for a in arrays),
                  clip_rho_threshold=rho_bar, clip_c_threshold=c_bar)
    vs, pg = _port(*arrays, clip_rho_threshold=rho_bar,
                   clip_c_threshold=c_bar)
    for got, want in ((vs, np.asarray(ref.vs)),
                      (pg, np.asarray(ref.pg_advantages))):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * max(1.0, np.abs(want).max()))
    if rho_bar == 1.0 and T > 1:
        # The fragment really is off-policy past the clip.
        assert (np.exp(arrays[1] - arrays[0]) > rho_bar).any()


def test_vtrace_hand_computed_clipped_rho_case():
    """T=2, B=1: gamma 0.9, values (1, 2), bootstrap 3, rewards
    (0.5, 1), rhos (2, 0.5) -> vs (3.065, 2.85), pg (2.065, 0.85)."""
    vs, pg = _port(np.log(np.array([[1.0], [1.0]], np.float32)),
                   np.log(np.array([[2.0], [0.5]], np.float32)),
                   np.array([[0.5], [1.0]], np.float32),
                   np.full((2, 1), 0.9, np.float32),
                   np.array([[1.0], [2.0]], np.float32),
                   np.array([3.0], np.float32))
    np.testing.assert_allclose(vs, [[3.065], [2.85]], rtol=1e-6)
    np.testing.assert_allclose(pg, [[2.065], [0.85]], rtol=1e-6)


def test_vtrace_on_policy_equals_nstep_return_and_td_advantage():
    rng = np.random.default_rng(7)
    T, B = 10, 3
    logp = rng.normal(size=(T, B)).astype(np.float32)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    bootstrap = rng.normal(size=B).astype(np.float32)
    discounts = np.full((T, B), 0.97, np.float32)
    vs, pg = _port(logp, logp, rewards, discounts, values, bootstrap)
    expected = np.empty_like(values)
    nxt = bootstrap.astype(np.float64)
    for t in range(T - 1, -1, -1):
        expected[t] = rewards[t] + discounts[t] * nxt
        nxt = expected[t]
    np.testing.assert_allclose(vs, expected, rtol=1e-5, atol=1e-5)
    vs_tp1 = np.concatenate([vs[1:], bootstrap[None]], axis=0)
    np.testing.assert_allclose(pg, rewards + discounts * vs_tp1 - values,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rho_bar,c_bar", [(1.0, 1.0), (2.0, 0.9),
                                           (0.5, 0.5)])
def test_vtrace_off_policy_matches_python_recursion(rho_bar, c_bar):
    behavior, target, rewards, discounts, values, bootstrap = _fragment(
        int(rho_bar * 10 + c_bar), 9, 4)
    vs, pg = _port(behavior, target, rewards, discounts, values, bootstrap,
                   clip_rho_threshold=rho_bar, clip_c_threshold=c_bar)
    ref_vs, ref_pg = _np_vtrace(behavior, target, rewards, discounts,
                                values, bootstrap, rho_bar, c_bar)
    np.testing.assert_allclose(vs, ref_vs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pg, ref_pg, rtol=1e-5, atol=1e-5)


def test_vtrace_zero_discount_stops_credit_flow():
    behavior, target, rewards, _, values, bootstrap = _fragment(3, 8, 2)
    discounts = np.full((8, 2), 0.99, np.float32)
    discounts[3] = 0.0            # a terminal transition at t=3
    vs1, _ = _port(behavior, target, rewards, discounts, values, bootstrap)
    rewards2, values2 = rewards.copy(), values.copy()
    rewards2[4:] += 100.0
    values2[4:] -= 50.0
    vs2, _ = _port(behavior, target, rewards2, discounts, values2,
                   bootstrap * 0 + 99)
    np.testing.assert_array_equal(vs1[:4], vs2[:4])


def test_vtrace_builds_no_graph():
    arrays = [torch.from_numpy(a).requires_grad_()
              for a in _fragment(5, 6)]
    out = vtrace(*arrays)
    assert not out.vs.requires_grad
    assert not out.pg_advantages.requires_grad
