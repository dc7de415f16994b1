"""Vectorized environments (the port's copy of ray_tpu/rllib/env.py,
numpy only).

The same seed gives the same episodes as the reference's: the dynamics,
the draws of `np.random.default_rng(seed)` and their order are the
reference's, line for line.  A VectorEnv steps all sub-environments in
one batched numpy computation and auto-resets finished ones.  The
registry holds the reference's four: CartPole-v1, Pendulum-v1 (one
continuous action in [-2, 2]), SyntheticPixel-v0 (84x84x4 uint8 frames)
and RepeatPrev-v0 (the memory probe of the recurrent policies).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


class Env:
    """Minimal gymnasium-style environment protocol.

    reset(seed) -> (obs, info); step(a) -> (obs, reward, terminated,
    truncated, info).  Discrete envs declare num_actions; continuous envs
    declare action_dim (+ action_low/high) and set num_actions = 0.
    """

    observation_dim: int
    num_actions: int = 0          # discrete action count (0 = continuous)
    action_dim: int = 0           # continuous action dimension
    action_low: float = -1.0
    action_high: float = 1.0

    def reset(self, seed: Optional[int] = None) -> Tuple[np.ndarray, dict]:
        raise NotImplementedError

    def step(self, action) -> Tuple[np.ndarray, float, bool, bool, dict]:
        raise NotImplementedError


class VectorEnv:
    """Batched environment: steps N environments as one numpy computation.

    Auto-resets finished sub-environments (obs returned for a done step is
    the *reset* observation, as in gymnasium's AutoResetWrapper) and tracks
    completed-episode returns/lengths for metrics.
    """

    def __init__(self, num_envs: int):
        self.num_envs = num_envs
        self._ep_return = np.zeros(num_envs, np.float64)
        self._ep_len = np.zeros(num_envs, np.int64)
        self.completed_returns: list = []
        self.completed_lengths: list = []

    # -- subclass interface ------------------------------------------------
    def reset_all(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def step_batch(self, actions: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Step every env; returns (obs, rewards, terminated, truncated).

        Implementations must auto-reset done envs internally.
        """
        raise NotImplementedError

    # -- common bookkeeping ------------------------------------------------
    def step(self, actions: np.ndarray):
        obs, rew, term, trunc = self.step_batch(np.asarray(actions))
        self._ep_return += rew
        self._ep_len += 1
        done = term | trunc
        if done.any():
            for i in np.nonzero(done)[0]:
                self.completed_returns.append(float(self._ep_return[i]))
                self.completed_lengths.append(int(self._ep_len[i]))
            self._ep_return[done] = 0.0
            self._ep_len[done] = 0
        return obs, rew, term, trunc

    def drain_episode_metrics(self) -> Tuple[list, list]:
        rets, lens = self.completed_returns, self.completed_lengths
        self.completed_returns, self.completed_lengths = [], []
        return rets, lens


class CartPoleVector(VectorEnv):
    """Vectorized CartPole-v1 (classic control, standard published dynamics).

    Physics constants and termination bounds are the classic cart-pole
    control problem (Barto/Sutton/Anderson 1983) as standardized by the
    CartPole-v1 task: episode caps at 500 steps, reward 1.0 per step.
    """

    observation_dim = 4
    num_actions = 2

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    LENGTH = 0.5          # half pole length
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_THRESHOLD = 12 * 2 * np.pi / 360
    X_THRESHOLD = 2.4
    MAX_STEPS = 500

    def __init__(self, num_envs: int, seed: int = 0):
        super().__init__(num_envs)
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros((num_envs, 4), np.float64)
        self._steps = np.zeros(num_envs, np.int64)

    def _sample_initial(self, n: int) -> np.ndarray:
        return self._rng.uniform(-0.05, 0.05, size=(n, 4))

    def reset_all(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._sample_initial(self.num_envs)
        self._steps[:] = 0
        self._ep_return[:] = 0.0
        self._ep_len[:] = 0
        return self._state.astype(np.float32)

    def step_batch(self, actions: np.ndarray):
        x, x_dot, theta, theta_dot = self._state.T
        force = np.where(actions == 1, self.FORCE_MAG, -self.FORCE_MAG)
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass = self.MASSCART + self.MASSPOLE
        polemass_length = self.MASSPOLE * self.LENGTH

        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASSPOLE * costheta**2 / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass

        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * xacc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * thetaacc
        self._state = np.stack([x, x_dot, theta, theta_dot], axis=1)
        self._steps += 1

        terminated = (np.abs(x) > self.X_THRESHOLD) | (
            np.abs(theta) > self.THETA_THRESHOLD)
        truncated = (~terminated) & (self._steps >= self.MAX_STEPS)
        rewards = np.ones(self.num_envs, np.float32)

        done = terminated | truncated
        if done.any():
            n = int(done.sum())
            self._state[done] = self._sample_initial(n)
            self._steps[done] = 0
        return (self._state.astype(np.float32), rewards, terminated, truncated)


class PendulumVector(VectorEnv):
    """Vectorized Pendulum-v1 (classic continuous control: swing-up with
    bounded torque; standard published dynamics/reward).  Episodes
    truncate at 200 steps; reward = -(theta^2 + 0.1*thetadot^2 +
    0.001*torque^2)."""

    observation_dim = 3
    num_actions = 0
    action_dim = 1
    action_low = -2.0
    action_high = 2.0

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0
    MAX_STEPS = 200

    def __init__(self, num_envs: int, seed: int = 0):
        super().__init__(num_envs)
        self._rng = np.random.default_rng(seed)
        self._theta = np.zeros(num_envs)
        self._thetadot = np.zeros(num_envs)
        self._steps = np.zeros(num_envs, np.int64)

    def _obs(self) -> np.ndarray:
        return np.stack([np.cos(self._theta), np.sin(self._theta),
                         self._thetadot], axis=1).astype(np.float32)

    def reset_all(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._theta = self._rng.uniform(-np.pi, np.pi, self.num_envs)
        self._thetadot = self._rng.uniform(-1.0, 1.0, self.num_envs)
        self._steps[:] = 0
        self._ep_return[:] = 0.0
        self._ep_len[:] = 0
        return self._obs()

    def step_batch(self, actions: np.ndarray):
        u = np.clip(np.asarray(actions, np.float64).reshape(self.num_envs),
                    -self.MAX_TORQUE, self.MAX_TORQUE)
        th, thdot = self._theta, self._thetadot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        costs = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        newthdot = thdot + (3 * self.G / (2 * self.L) * np.sin(th)
                            + 3.0 / (self.M * self.L ** 2) * u) * self.DT
        newthdot = np.clip(newthdot, -self.MAX_SPEED, self.MAX_SPEED)
        self._theta = th + newthdot * self.DT
        self._thetadot = newthdot
        self._steps += 1
        truncated = self._steps >= self.MAX_STEPS
        terminated = np.zeros(self.num_envs, bool)
        if truncated.any():
            n = int(truncated.sum())
            self._theta[truncated] = self._rng.uniform(-np.pi, np.pi, n)
            self._thetadot[truncated] = self._rng.uniform(-1.0, 1.0, n)
            self._steps[truncated] = 0
        return (self._obs(), (-costs).astype(np.float32), terminated,
                truncated)


class SyntheticPixelVector(VectorEnv):
    """Synthetic [84, 84, 4]-observation env at Atari frame shapes.

    Stands in for gym Atari (not in this image) wherever the QUESTION is
    pixel-pipeline throughput and conv-policy plumbing rather than game
    dynamics (the reference's Atari-shaped throughput env).
    A bright 8x8 patch moves over a fixed textured background; the agent
    is rewarded for naming the patch's quadrant (4 actions), so policies
    CAN learn signal from pixels, while obs generation stays cheap enough
    (one tile overlay per step) that the framework, not numpy, is what a
    throughput run measures.  uint8 observations end to end — buffers and
    transport move 1 byte/px; the conv net scales to [0,1] on the device.
    """

    observation_dim = (84, 84, 4)
    num_actions = 4
    MAX_STEPS = 128
    PATCH = 8

    def __init__(self, num_envs: int, seed: int = 0):
        super().__init__(num_envs)
        self._rng = np.random.default_rng(seed)
        # One shared textured background (fixed; regenerating 84*84*4*B
        # pixels per step would benchmark numpy instead of the runtime).
        self._bg = self._rng.integers(
            0, 64, size=(84, 84, 4), dtype=np.uint8)
        self._pos = np.zeros((num_envs, 2), np.int64)
        self._steps = np.zeros(num_envs, np.int64)

    def _roll_pos(self, mask=None):
        fresh = self._rng.integers(0, 84 - self.PATCH,
                                   size=(self.num_envs, 2))
        if mask is None:
            self._pos = fresh
        else:
            self._pos = np.where(mask[:, None], fresh, self._pos)

    def _obs(self) -> np.ndarray:
        obs = np.broadcast_to(
            self._bg, (self.num_envs, 84, 84, 4)).copy()
        p = self.PATCH
        for i in range(self.num_envs):   # p*p*4 writes per env, cheap
            y, x = self._pos[i]
            obs[i, y:y + p, x:x + p, :] = 255
        return obs

    def _quadrant(self) -> np.ndarray:
        cy = (self._pos[:, 0] + self.PATCH // 2) >= 42
        cx = (self._pos[:, 1] + self.PATCH // 2) >= 42
        return (cy.astype(np.int64) * 2 + cx.astype(np.int64))

    def reset_all(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._roll_pos()
        self._steps[:] = 0
        self._ep_return[:] = 0.0
        self._ep_len[:] = 0
        return self._obs()

    def step_batch(self, actions: np.ndarray):
        rewards = (np.asarray(actions) == self._quadrant()
                   ).astype(np.float32)
        self._steps += 1
        truncated = self._steps >= self.MAX_STEPS
        terminated = np.zeros(self.num_envs, bool)
        self._roll_pos()
        if truncated.any():
            self._steps[truncated] = 0
        return self._obs(), rewards, terminated, truncated


class RepeatPrevVector(VectorEnv):
    """Memory probe: at every step the agent sees a one-hot symbol and is
    rewarded for emitting the PREVIOUS step's symbol.  The current
    observation carries zero information about the correct action, so a
    feedforward policy is capped at chance (1/K) while one step of
    memory solves it exactly — the standard separation task for
    recurrent policies (reference: rllib's RepeatAfterMeEnv,
    examples/env/repeat_after_me_env.py, used by the LSTM examples)."""

    K = 3
    MAX_STEPS = 48
    observation_dim = 3   # == K
    num_actions = 3       # == K

    def __init__(self, num_envs: int, seed: int = 0):
        super().__init__(num_envs)
        self._rng = np.random.default_rng(seed)
        self._sym = np.zeros(num_envs, np.int64)
        self._prev = np.zeros(num_envs, np.int64)
        self._steps = np.zeros(num_envs, np.int64)

    def _obs(self) -> np.ndarray:
        return np.eye(self.K, dtype=np.float32)[self._sym]

    def reset_all(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._sym = self._rng.integers(0, self.K, self.num_envs)
        self._prev[:] = self._sym   # step 0: reward "repeat what you see"
        self._steps[:] = 0
        self._ep_return[:] = 0.0
        self._ep_len[:] = 0
        return self._obs()

    def step_batch(self, actions: np.ndarray):
        rewards = (np.asarray(actions) == self._prev).astype(np.float32)
        self._prev = self._sym
        self._sym = self._rng.integers(0, self.K, self.num_envs)
        self._steps += 1
        truncated = self._steps >= self.MAX_STEPS
        terminated = np.zeros(self.num_envs, bool)
        if truncated.any():
            self._steps[truncated] = 0
            self._prev[truncated] = self._sym[truncated]
        return self._obs(), rewards, terminated, truncated


_ENV_REGISTRY: Dict[str, Callable[..., VectorEnv]] = {
    "CartPole-v1": CartPoleVector,
    "Pendulum-v1": PendulumVector,
    "SyntheticPixel-v0": SyntheticPixelVector,
    "RepeatPrev-v0": RepeatPrevVector,
}


def register_env(name: str, creator: Callable[..., VectorEnv]) -> None:
    """Register a vector-env creator: creator(num_envs, seed) -> VectorEnv.

    Reference: ray.tune.registry.register_env.
    """
    _ENV_REGISTRY[name] = creator


def shippable_env(env: Any) -> Any:
    """What to ship to a remote worker for `env`: a registered name's
    creator, by value (a worker process has a fresh registry, where the
    name would resolve to whatever that registry holds); anything else
    as it is."""
    if isinstance(env, str) and env in _ENV_REGISTRY:
        return _ENV_REGISTRY[env]
    return env


def make_vector_env(name_or_creator: Any, num_envs: int,
                    seed: int = 0) -> VectorEnv:
    if callable(name_or_creator):
        return name_or_creator(num_envs, seed)
    if name_or_creator in _ENV_REGISTRY:
        return _ENV_REGISTRY[name_or_creator](num_envs, seed=seed)
    raise ValueError(f"unknown env {name_or_creator!r}; "
                     f"registered: {sorted(_ENV_REGISTRY)}")
