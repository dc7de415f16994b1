"""Algorithm: the RL training driver (port of ray_tpu/rllib/algorithm.py).

`AlgorithmConfig` is the reference's fluent config, with what the port
cannot import passed in instead:
- `.resources(runtime=ray_tpu)`: the runtime handle (`remote`, `put`,
  `get`, `wait`, `kill`) that remote rollout workers need; without one,
  `num_rollout_workers` must be 0;
- `.resources(device=..., rollout_device=...)`: where the learner and
  the rollout policies run (None -> CUDA for both; the CPU tests pass
  "cpu");
- `.debugging(observer=...)`: the `util.observe.Observer` that receives
  the rl plane's events, spans and metrics.

`learner_mesh` refuses anything but None (the multi-device slice), and
multi-agent configs wait for `multi_agent.py`.  `save`, `restore` and
`as_trainable` bind the reference's `air.Checkpoint` and Tune: they wait
for the Tune binding (ROADMAP A9); `save_to_dict` / `restore_from_dict`
are ported.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch._device import MULTI_DEVICE
from ray_tpu_torch.rllib.env import make_vector_env

_TUNE = "waits for the Tune binding of ROADMAP A9"


class AlgorithmConfig:
    """Fluent config (.environment().rollouts().training().resources())."""

    def __init__(self, algo_class=None):
        self.algo_class = algo_class
        self.env: Any = "CartPole-v1"
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 8
        self.rollout_fragment_length = 64
        self.num_cpus_per_worker = 1.0
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.lr = 3e-4
        self.grad_clip = 0.5
        self.train_batch_size = 1024
        self.sgd_minibatch_size = 128
        self.num_sgd_iter = 8
        self.model_hidden = (64, 64)
        self.use_lstm = False
        self.lstm_size = 64
        self.seed = 0
        self.runtime: Any = None
        self.device: Any = None
        self.rollout_device: Any = None
        self.observer: Any = None
        self.extra: Dict[str, Any] = {}

    # fluent setters ------------------------------------------------------
    def environment(self, env) -> "AlgorithmConfig":
        self.env = env
        return self

    def rollouts(self, *, num_rollout_workers: Optional[int] = None,
                 num_envs_per_worker: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None
                 ) -> "AlgorithmConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if hasattr(self, k):
                setattr(self, k, v)
            else:
                self.extra[k] = v
        return self

    def resources(self, *, num_cpus_per_worker: Optional[float] = None,
                  learner_mesh: Any = None, runtime: Any = None,
                  device: Any = None, rollout_device: Any = None
                  ) -> "AlgorithmConfig":
        if learner_mesh is not None:
            raise NotImplementedError(
                f"learner_mesh (data-parallel learners) waits for "
                f"{MULTI_DEVICE}")
        if num_cpus_per_worker is not None:
            self.num_cpus_per_worker = num_cpus_per_worker
        if runtime is not None:
            self.runtime = runtime
        if device is not None:
            self.device = device
        if rollout_device is not None:
            self.rollout_device = rollout_device
        return self

    def multi_agent(self, *, policies, policy_mapping_fn=None):
        raise NotImplementedError("multi-agent configs wait for "
                                  "multi_agent.py (ROADMAP A9)")

    def debugging(self, *, seed: Optional[int] = None,
                  observer: Any = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        if observer is not None:
            self.observer = observer
        return self

    def to_dict(self) -> Dict[str, Any]:
        d = {k: v for k, v in self.__dict__.items()
             if k not in ("algo_class", "extra", "runtime", "observer")}
        d.update(self.extra)
        return d

    def build(self) -> "Algorithm":
        if self.algo_class is None:
            raise ValueError("config has no algo_class; use PPOConfig() etc.")
        return self.algo_class(self)


class Algorithm:
    """Base RL driver: owns a WorkerSet + learner; .train() = one iteration."""

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        # Probe the env spec once, locally, to size the model.
        probe = make_vector_env(config.env, 1, seed=config.seed)
        self.obs_dim = probe.observation_dim
        self.num_actions = probe.num_actions
        self.action_dim = getattr(probe, "action_dim", 0)
        self.continuous = self.num_actions == 0 and self.action_dim > 0
        self.iteration = 0
        self.total_env_steps = 0
        self._episode_returns: collections.deque = collections.deque(
            maxlen=100)
        self._episode_lengths: collections.deque = collections.deque(
            maxlen=100)
        self._start = time.time()
        self.setup()

    def worker_kwargs(self, **extra) -> Dict[str, Any]:
        """The rollout workers' constructor arguments from the config."""
        cfg = self.config
        return dict(env=cfg.env, num_envs=cfg.num_envs_per_worker,
                    rollout_fragment_length=cfg.rollout_fragment_length,
                    gamma=cfg.gamma, lam=cfg.lambda_,
                    hidden=cfg.model_hidden, seed=cfg.seed,
                    device=cfg.rollout_device, **extra)

    # -- subclass hooks ----------------------------------------------------
    def setup(self) -> None:
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    # -- public ------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        """One training iteration.  Reference: Algorithm.step."""
        result = self.training_step()
        self.iteration += 1
        rets = list(self._episode_returns)
        result.update({
            "training_iteration": self.iteration,
            "timesteps_total": self.total_env_steps,
            "episode_reward_mean": float(np.mean(rets)) if rets else np.nan,
            "episode_reward_max": float(np.max(rets)) if rets else np.nan,
            "episode_reward_min": float(np.min(rets)) if rets else np.nan,
            "episode_len_mean": (float(np.mean(self._episode_lengths))
                                 if self._episode_lengths else np.nan),
            "episodes_this_iter": result.get("episodes_this_iter", 0),
            "time_total_s": time.time() - self._start,
        })
        return result

    def _record_metrics(self, metrics_list) -> int:
        """Fold worker sample metrics into the running episode window."""
        episodes = 0
        for m in metrics_list:
            self._episode_returns.extend(m.get("episode_returns", []))
            self._episode_lengths.extend(m.get("episode_lengths", []))
            episodes += len(m.get("episode_returns", []))
            self.total_env_steps += m.get("env_steps", 0)
        return episodes

    def save_to_dict(self) -> Dict[str, Any]:
        raise NotImplementedError

    def restore_from_dict(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    def save(self):
        raise NotImplementedError(f"Algorithm.save {_TUNE}; use "
                                  f"save_to_dict")

    def restore(self, checkpoint) -> None:
        raise NotImplementedError(f"Algorithm.restore {_TUNE}; use "
                                  f"restore_from_dict")

    @classmethod
    def as_trainable(cls, config: AlgorithmConfig, **kwargs):
        raise NotImplementedError(f"Algorithm.as_trainable {_TUNE}")

    def stop(self) -> None:
        if getattr(self, "workers", None) is not None:
            self.workers.stop()
