"""Contextual bandits: LinUCB and Linear Thompson Sampling (port of
ray_tpu/rllib/bandit.py).

Per-arm ridge regression (A_a = lambda*I + sum x x^T, b_a = sum r x)
with arm choice by UCB (theta.x + alpha*sqrt(x A^-1 x), Li et al. 2010)
or by posterior sampling (theta ~ N(A^-1 b, v^2 A^-1), Agrawal & Goyal
2013).  The model's A^-1 [k, d, d] and b [k, d] are float64 tensors on
the algorithm's device (`.resources(device=...)`, None -> CUDA); the
Sherman-Morrison update runs one row at a time in the reference's order,
so when two rows of a batch pick the same arm the second sees the
first's update.  LinUCB chooses on the device and only the arms come
home; LinTS draws its posterior samples with the reference's
`default_rng(seed + 99).multivariate_normal` from host copies of theta
and v^2 A^-1, so both packages pick the same arms.  Checkpoints hold
numpy f64 arrays under the reference's keys.

Bandits are online and local to the algorithm (no worker fleet): the
batch of contexts steps through a VectorEnv whose every step is a
terminal one-step episode, so episode_reward_mean is the per-decision
reward.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import VectorEnv, make_vector_env, register_env


class LinearBanditVector(VectorEnv):
    """Synthetic contextual bandit: context x ~ U[-1,1]^d, arm a's
    expected reward = theta_a . x (+ Gaussian noise); every step is a
    one-step episode.  The optimal arm depends on the context, so a
    non-contextual strategy cannot win."""

    observation_dim = 4
    num_actions = 3
    NOISE = 0.05

    def __init__(self, num_envs: int, seed: int = 0):
        super().__init__(num_envs)
        self._rng = np.random.default_rng(seed)
        d, k = self.observation_dim, self.num_actions
        # Fixed arm parameters (drawn once, the same for every env seed).
        self.theta = np.random.default_rng(1234).standard_normal((k, d))
        self._ctx = np.zeros((num_envs, d), np.float32)

    def _draw(self):
        self._ctx = self._rng.uniform(
            -1, 1, (self.num_envs, self.observation_dim)).astype(np.float32)

    def reset_all(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._draw()
        return self._ctx.copy()

    def expected_rewards(self) -> np.ndarray:
        """[n, k] expected reward per arm for the CURRENT contexts
        (oracle surface for regret measurement)."""
        return self._ctx @ self.theta.T

    def step_batch(self, actions):
        exp = self.expected_rewards()
        rew = (exp[np.arange(self.num_envs), actions]
               + self.NOISE * self._rng.standard_normal(self.num_envs))
        term = np.ones(self.num_envs, bool)
        self._draw()                      # auto-reset: next contexts
        return self._ctx.copy(), rew, term, np.zeros(self.num_envs, bool)


register_env("LinearBandit-v0", LinearBanditVector)


class _LinearModel:
    """Per-arm ridge state with a rank-1-maintained inverse, f64 on
    `device`."""

    def __init__(self, n_arms: int, dim: int, lam: float = 1.0,
                 device: DeviceLike = None):
        self.n_arms, self.dim = n_arms, dim
        self.device = resolve_device(device)
        self.A_inv = (torch.eye(dim, dtype=torch.float64, device=self.device)
                      / lam).repeat(n_arms, 1, 1)
        self.b = torch.zeros(n_arms, dim, dtype=torch.float64,
                             device=self.device)

    def theta(self) -> torch.Tensor:                     # [k, d]
        return torch.einsum("kij,kj->ki", self.A_inv, self.b)

    def update(self, arms: np.ndarray, xs: torch.Tensor, rs: torch.Tensor):
        """Sherman-Morrison, (A + x x^T)^-1, one row at a time."""
        for i, a in enumerate(arms.tolist()):
            x, Ai = xs[i], self.A_inv[a]
            Aix = Ai @ x
            Ai.sub_(torch.outer(Aix, Aix) / (1.0 + x @ Aix))
            self.b[a] += rs[i] * x

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {"A_inv": self.A_inv.to("cpu", copy=True).numpy(),
                "b": self.b.to("cpu", copy=True).numpy()}

    def load_numpy(self, state: Dict[str, Any]) -> None:
        self.A_inv = torch.tensor(np.asarray(state["A_inv"]),
                                  dtype=torch.float64, device=self.device)
        self.b = torch.tensor(np.asarray(state["b"]), dtype=torch.float64,
                              device=self.device)


class LinUCBConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=LinUCB)
        self.env = "LinearBandit-v0"
        self.num_envs_per_worker = 16
        self.steps_per_iteration = 8
        self.alpha = 1.0       # exploration bonus scale
        self.lambda_reg = 1.0


class LinUCB(Algorithm):
    """Disjoint LinUCB (Li et al. 2010, Algorithm 1)."""

    def setup(self) -> None:
        cfg = self.config
        self.model = _LinearModel(self.num_actions, self.obs_dim,
                                  getattr(cfg, "lambda_reg", 1.0),
                                  device=cfg.device)
        self.env = make_vector_env(cfg.env, cfg.num_envs_per_worker,
                                   seed=cfg.seed)
        self._obs = self.env.reset_all(seed=cfg.seed)
        self.workers = None

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float64)).to(
            self.model.device)

    def _choose(self, obs: np.ndarray) -> np.ndarray:
        x = self._to_device(obs)                          # [n, d]
        mean = x @ self.model.theta().T                   # [n, k]
        # x^T A_a^-1 x for every (context, arm):
        var = torch.einsum("ni,kij,nj->nk", x, self.model.A_inv, x)
        score = mean + self.config.alpha * var.clamp(min=0).sqrt()
        return score.argmax(-1).cpu().numpy()

    def training_step(self) -> Dict[str, Any]:
        rewards = []
        for _ in range(self.config.steps_per_iteration):
            arms = self._choose(self._obs)
            obs, rew, term, trunc = self.env.step(arms)
            self.model.update(arms, self._to_device(self._obs),
                              self._to_device(rew))
            rewards.append(rew)
            self._obs = obs
        rets, lens = self.env.drain_episode_metrics()
        self._episode_returns.extend(rets)
        self._episode_lengths.extend(lens)
        n = sum(len(r) for r in rewards)
        self.total_env_steps += n
        return {"episodes_this_iter": len(rets),
                "mean_reward": float(np.concatenate(rewards).mean())}

    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        return self._choose(np.atleast_2d(obs))

    def save_to_dict(self) -> Dict[str, Any]:
        return self.model.to_numpy()

    def restore_from_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_numpy(state)


class LinTSConfig(LinUCBConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = LinTS
        self.posterior_scale = 0.3   # v: posterior stddev multiplier


class LinTS(LinUCB):
    """Linear Thompson Sampling (Agrawal & Goyal 2013): choose the arm
    maximizing x . theta_tilde with theta_tilde ~ N(theta_a, v^2 A_a^-1)
    per arm."""

    def setup(self) -> None:
        super().setup()
        self._ts_rng = np.random.default_rng(self.config.seed + 99)

    def _choose(self, obs: np.ndarray) -> np.ndarray:
        v = self.config.posterior_scale
        theta = self.model.theta().cpu().numpy()
        A_inv = self.model.A_inv.cpu().numpy()
        sampled = np.stack([
            self._ts_rng.multivariate_normal(theta[a], v * v * A_inv[a])
            for a in range(self.model.n_arms)])           # [k, d]
        return (obs @ sampled.T).argmax(-1)
