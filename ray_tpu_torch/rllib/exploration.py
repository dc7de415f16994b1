"""Exploration strategies, decoupled from algorithms (the port's copy of
ray_tpu/rllib/exploration.py, numpy only).

Schedules (constant, linear, piecewise) and the strategies a rollout
worker applies to the policy's proposed actions once per vectorized
step: EpsilonGreedy, GaussianNoise, OrnsteinUhlenbeckNoise and Random
(reference: rllib/utils/exploration/ and rllib/utils/schedules/).  The
draws come from the worker's numpy generator, in the reference's order,
so the same seed gives the same actions in either package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Schedules (reference: rllib/utils/schedules/)
# ---------------------------------------------------------------------------

class Schedule:
    def value(self, t: int) -> float:
        raise NotImplementedError

    def __call__(self, t: int) -> float:
        return self.value(t)


class ConstantSchedule(Schedule):
    def __init__(self, v: float):
        self.v = float(v)

    def value(self, t: int) -> float:
        return self.v


class LinearSchedule(Schedule):
    """initial -> final over horizon steps, then flat."""

    def __init__(self, initial: float, final: float, horizon: int):
        self.initial, self.final, self.horizon = initial, final, max(horizon, 1)

    def value(self, t: int) -> float:
        frac = min(1.0, t / self.horizon)
        return self.initial + (self.final - self.initial) * frac


class PiecewiseSchedule(Schedule):
    """[(t, v), ...] endpoints with linear interpolation between them."""

    def __init__(self, endpoints: Sequence[Tuple[int, float]]):
        self.points = sorted(endpoints)

    def value(self, t: int) -> float:
        pts = self.points
        if t <= pts[0][0]:
            return pts[0][1]
        for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
            if t0 <= t < t1:
                frac = (t - t0) / max(t1 - t0, 1)
                return v0 + (v1 - v0) * frac
        return pts[-1][1]


# ---------------------------------------------------------------------------
# Exploration strategies
# ---------------------------------------------------------------------------

class Exploration:
    """Post-processes a batch of proposed actions.

    apply(actions, timestep, rng) -> actions.  `actions` is the policy's
    proposal for the whole env batch; implementations return the batch to
    actually execute."""

    def apply(self, actions: np.ndarray, timestep: int,
              rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError


class EpsilonGreedy(Exploration):
    """Uniform-random action with probability epsilon(t) (reference:
    epsilon_greedy.py; the default for value-based algorithms)."""

    def __init__(self, num_actions: int,
                 initial: float = 1.0, final: float = 0.02,
                 horizon: int = 10_000,
                 schedule: Optional[Schedule] = None):
        self.num_actions = num_actions
        self.schedule = schedule or LinearSchedule(initial, final, horizon)

    def apply(self, actions, timestep, rng):
        eps = self.schedule(timestep)
        b = len(actions)
        mask = rng.random(b) < eps
        return np.where(mask, rng.integers(0, self.num_actions, b), actions)


class GaussianNoise(Exploration):
    """Additive N(0, scale(t)) noise on continuous actions, clipped to
    bounds (reference: gaussian_noise.py; TD3's default)."""

    def __init__(self, low: float, high: float, scale: float = 0.1,
                 schedule: Optional[Schedule] = None):
        self.low, self.high = low, high
        self.schedule = schedule or ConstantSchedule(scale)

    def apply(self, actions, timestep, rng):
        scale = self.schedule(timestep)
        noise = rng.normal(0.0, scale, size=np.shape(actions))
        return np.clip(actions + noise, self.low, self.high)


class OrnsteinUhlenbeckNoise(Exploration):
    """Temporally-correlated OU noise (reference:
    ornstein_uhlenbeck_noise.py; the classic DDPG exploration): state
    follows dx = theta*(mu - x)*dt + sigma*sqrt(dt)*N(0,1) per env."""

    def __init__(self, low: float, high: float, *, theta: float = 0.15,
                 sigma: float = 0.2, dt: float = 1.0, mu: float = 0.0):
        self.low, self.high = low, high
        self.theta, self.sigma, self.dt, self.mu = theta, sigma, dt, mu
        self._state: Optional[np.ndarray] = None

    def apply(self, actions, timestep, rng):
        actions = np.asarray(actions, np.float64)
        if self._state is None or self._state.shape != actions.shape:
            self._state = np.zeros_like(actions)
        self._state = (self._state
                       + self.theta * (self.mu - self._state) * self.dt
                       + self.sigma * np.sqrt(self.dt)
                       * rng.normal(size=actions.shape))
        return np.clip(actions + self._state, self.low, self.high)


class Random(Exploration):
    """Fully random actions (reference: random.py; warmup phases)."""

    def __init__(self, num_actions: int = 0, action_dim: int = 0,
                 low: float = -1.0, high: float = 1.0):
        self.num_actions = num_actions
        self.action_dim = action_dim
        self.low, self.high = low, high

    def apply(self, actions, timestep, rng):
        b = len(actions)
        if self.num_actions:
            return rng.integers(0, self.num_actions, b)
        return rng.uniform(self.low, self.high,
                           size=(b, self.action_dim)).astype(np.float32)
