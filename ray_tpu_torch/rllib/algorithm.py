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

`.multi_agent(policies=..., policy_mapping_fn=...)` declares a policy
map; the algorithm then probes a multi-agent env (`multi_agent.py`) and
sizes one model per policy.  `learner_mesh` refuses anything but None
(the multi-device slice).

`save()` returns the port's dict `Checkpoint` (`ray_tpu_torch.air`) of
`save_to_dict()` plus `iteration` and `total_env_steps`; `restore()`
reads any object with `to_dict()`, so the reference's checkpoints
restore here and the port's in the reference.  `as_trainable` wraps the
algorithm into a Tune function trainable; Tune's `report` reaches it as
a handle (the argument, or `runtime.tune.report`), never an import.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from ray_tpu_torch._device import MULTI_DEVICE
from ray_tpu_torch.air import Checkpoint
from ray_tpu_torch.rllib.env import make_vector_env
from ray_tpu_torch.rllib.multi_agent import make_multi_agent_env


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
        # Multi-agent: policies = iterable of policy ids (None =
        # single-agent); policy_mapping_fn: agent_id -> policy_id (default:
        # identity).
        self.policies: Any = None
        self.policy_mapping_fn: Any = None
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

    def multi_agent(self, *, policies, policy_mapping_fn=None
                    ) -> "AlgorithmConfig":
        """Declare the policy map."""
        self.policies = list(policies)
        self.policy_mapping_fn = policy_mapping_fn
        return self

    def debugging(self, *, seed: Optional[int] = None,
                  observer: Any = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        if observer is not None:
            self.observer = observer
        return self

    def to_dict(self) -> Dict[str, Any]:
        d = {k: v for k, v in self.__dict__.items()
             if k not in ("algo_class", "extra", "runtime", "observer",
                          "policy_mapping_fn")}
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
        self.multi_agent = config.policies is not None
        if self.multi_agent:
            probe = make_multi_agent_env(config.env, 1, seed=config.seed)
            mapping = config.policy_mapping_fn or (lambda aid: aid)
            # Per-policy model sizing from the agents each policy serves.
            self.policy_specs: Dict[str, tuple] = {}
            for a in probe.agent_ids:
                self.policy_specs[mapping(a)] = (
                    probe.observation_dims[a], probe.num_actions_by_agent[a])
            self.obs_dim = self.num_actions = self.action_dim = 0
            self.continuous = False
        else:
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

    def save(self) -> Checkpoint:
        state = self.save_to_dict()
        state["iteration"] = self.iteration
        state["total_env_steps"] = self.total_env_steps
        return Checkpoint.from_dict(state)

    def restore(self, checkpoint) -> None:
        """Restore from any checkpoint with `to_dict()`: the port's, or
        the reference's `air.Checkpoint`."""
        state = checkpoint.to_dict()
        self.iteration = state.get("iteration", 0)
        self.total_env_steps = state.get("total_env_steps", 0)
        self.restore_from_dict(state)

    def stop(self) -> None:
        if getattr(self, "workers", None) is not None:
            self.workers.stop()

    # -- Tune integration --------------------------------------------------
    @classmethod
    def as_trainable(cls, config: AlgorithmConfig, *,
                     stop_iters: int = 1000,
                     stop_reward: Optional[float] = None,
                     report: Optional[Callable[[dict], Any]] = None):
        """Wrap into a Tune function trainable that loops train() and
        reports each result.  `report` is Tune's report function; without
        one, `runtime.tune.report` of the config's runtime handle
        (`.resources(runtime=ray_tpu)`).  A Tune config's keys overwrite
        the config's attributes of the same names."""
        if report is None:
            tune = getattr(config.runtime, "tune", None)
            report = getattr(tune, "report", None)
        if report is None:
            raise ValueError(
                "as_trainable needs Tune's report: pass report=, or give "
                "the config a runtime handle with .tune.report "
                "(config.resources(runtime=ray_tpu))")

        def _trainable(tune_config: Dict[str, Any]):
            cfg = config
            for k, v in (tune_config or {}).items():
                if hasattr(cfg, k):
                    setattr(cfg, k, v)
            algo = cls(cfg)
            try:
                for _ in range(stop_iters):
                    result = algo.train()
                    report(result)
                    if (stop_reward is not None
                            and result["episode_reward_mean"] >= stop_reward):
                        break
            finally:
                algo.stop()
        return _trainable
