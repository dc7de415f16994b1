"""DQN: deep Q-learning with replay and a target network (port of
ray_tpu/rllib/dqn.py), and the off-policy training loop that SAC and TD3
share with it.

`_QLearner`'s TD update: Q(s, a) from the actor-critic's logits head
(its value head unused), the target max over the target network at the
online network's argmax (double Q) or its own, r + gamma * Q' * (1 -
terminated) with `n_step_gamma` for gamma when set, the Huber loss, then
optax's clip_by_global_norm and adam(eps=1e-5) (`ClipAdam`).

The reference's target is an alias of the params (`target_params =
params`), a snapshot only because JAX arrays are immutable.  The port
updates its params in place, so the target is a copy, made at init and
at every `sync_target`: between syncs no update moves it.
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import ClipAdam, batch_tensors
from ray_tpu_torch.rllib.models import make_model
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.rllib.worker_set import WorkerSet


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=DQN)
        self.lr = 1e-3
        self.grad_clip = 10.0
        self.replay_buffer_capacity = 50_000
        self.learning_starts = 1_000
        self.train_batch_size = 128
        self.updates_per_step = 32
        self.target_update_freq = 250      # updates between target syncs
        self.double_q = True
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 8_000
        self.n_step_gamma = None           # defaults to cfg.gamma


def frozen_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A target network: a copy of `model` that no gradient reaches."""
    return copy.deepcopy(model).requires_grad_(False)


def metrics_to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Device scalars as floats, in one host copy."""
    values = torch.stack([v.detach().float() for v in metrics.values()])
    return dict(zip(metrics, values.tolist()))


class _QLearner:
    """TD update over (s, a, r, s', done) minibatches; `device=None`
    means CUDA."""

    def __init__(self, obs_dim, num_actions: int, cfg: DQNConfig, hidden,
                 seed: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = make_model(obs_dim, num_actions, hidden, seed=seed,
                                device=self.device)
        self.target = frozen_copy(self.model)
        self.opt = ClipAdam(self.model.parameters(), cfg.lr, cfg.grad_clip)
        self.num_updates = 0
        self.gamma = cfg.n_step_gamma or cfg.gamma
        self.double_q = cfg.double_q
        self._lock = threading.Lock()

    def loss(self, batch: Dict[str, torch.Tensor]):
        """(huber loss, metrics) of a minibatch of tensors."""
        obs, next_obs = batch["obs"], batch["next_obs"]
        n = len(obs)
        if self.double_q:
            q_both, _ = self.model(torch.cat([obs, next_obs]))
            q_all, q_next_online = q_both[:n], q_both[n:].detach()
        else:
            q_all, _ = self.model(obs)
        q = q_all.gather(1, batch["actions"].long()[:, None])[:, 0]
        with torch.no_grad():
            q_next_t, _ = self.target(next_obs)
            best = torch.argmax(q_next_online if self.double_q
                                else q_next_t, dim=1)
            q_target_next = q_next_t.gather(1, best[:, None])[:, 0]
            target = batch["rewards"] + self.gamma * q_target_next * (
                1.0 - batch["dones"].float())
        td = q - target
        huber = torch.where(td.abs() < 1.0, 0.5 * td ** 2, td.abs() - 0.5)
        return huber.mean(), {"td_error_mean": td.abs().mean(),
                              "q_mean": q.mean()}

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        total, metrics = self.loss(batch_tensors(batch, self.device))
        # The value head is unused: its gradients are zeros, as JAX's.
        grads = torch.autograd.grad(total, self.opt.params,
                                    allow_unused=True, materialize_grads=True)
        with self._lock:
            self.opt.step(grads)
            self.num_updates += 1
        metrics["loss"] = total
        return metrics_to_host(metrics)

    @torch.no_grad()
    def sync_target(self) -> None:
        with self._lock:
            self.target.load_state_dict(self.model.state_dict())

    def get_weights(self):
        with self._lock:
            return convert.actor_critic_variables(self.model)

    def get_state(self):
        opt = self.opt
        with self._lock:
            return {"params": convert.actor_critic_variables(self.model),
                    "target_params": convert.actor_critic_variables(
                        self.target),
                    "opt_state": convert.rl_opt_state_tree(
                        opt.count, opt.mu, opt.nu, self.model)}

    def set_state(self, state):
        sd = convert.actor_critic_state_dict(state["params"], self.model)
        td = convert.actor_critic_state_dict(state["target_params"],
                                             self.target)
        count, mu, nu = convert.rl_adam_state(state["opt_state"],
                                              self.model)
        with self._lock:
            self.model.load_state_dict(sd)
            self.target.load_state_dict(td)
            self.opt.count = count
            for dst, src in zip(self.opt.mu + self.opt.nu, mu + nu):
                dst.copy_(src)


def _to_transitions(batch: SampleBatch) -> SampleBatch:
    """Time-major fragment [T, B] -> flat (s, a, r, s', done) rows.  The
    next obs within a fragment is the next timestep; the last timestep
    bootstraps from the fragment's bootstrap_obs."""
    obs = batch[SampleBatch.OBS]                     # [T, B, D]
    next_obs = np.concatenate(
        [obs[1:], batch["bootstrap_obs"][None]], axis=0)
    # Only true termination zeroes the bootstrap term; a TRUNCATED episode
    # (time limit) still bootstraps from next_obs — treating it as
    # terminal would teach Q that surviving to the limit is worthless.
    done = batch[SampleBatch.TERMINATEDS]

    def flat(x):
        return x.reshape((-1,) + x.shape[2:])

    return SampleBatch({
        "obs": flat(obs), "next_obs": flat(next_obs),
        "actions": flat(batch[SampleBatch.ACTIONS]),
        "rewards": flat(batch[SampleBatch.REWARDS]),
        "dones": flat(done),
    })


class OffPolicyAlgorithm(Algorithm):
    """The store-rollouts -> replay-sample -> update loop of DQN, SAC and
    TD3.  Subclasses set `self.workers`, `self.learner` and `self.buffer`
    in `setup`; `_after_update` runs after each learner update."""

    def _after_update(self) -> None:
        pass

    def training_step(self) -> Dict[str, Any]:
        """sample -> store -> updates_per_step updates once the buffer
        holds learning_starts rows -> weight broadcast."""
        cfg = self.config
        batches, metrics_list = self.workers.sample_sync()
        episodes = self._record_metrics(metrics_list)
        for b in batches:
            self.buffer.add(_to_transitions(b))

        learner_metrics: Dict[str, float] = {}
        updates = 0
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.updates_per_step):
                learner_metrics.update(self.learner.update(
                    self.buffer.sample(cfg.train_batch_size)))
                updates += 1
                self._after_update()
            self.workers.sync_weights(self.learner.get_weights())

        return {"episodes_this_iter": episodes,
                "buffer_size": len(self.buffer),
                "learner_updates_total": self.learner.num_updates,
                "updates_this_iter": updates,
                **{f"learner/{k}": v for k, v in learner_metrics.items()}}

    def save_to_dict(self) -> Dict[str, Any]:
        return {"learner_state": self.learner.get_state(),
                "config": self.config.to_dict()}

    def restore_from_dict(self, state: Dict[str, Any]) -> None:
        self.learner.set_state(state["learner_state"])
        self.workers.sync_weights(self.learner.get_weights())


class DQN(OffPolicyAlgorithm):
    def setup(self) -> None:
        cfg = self.config
        self.workers = WorkerSet(
            num_workers=cfg.num_rollout_workers, runtime=cfg.runtime,
            num_cpus_per_worker=cfg.num_cpus_per_worker,
            worker_kwargs=self.worker_kwargs(
                postprocess=False,
                epsilon_schedule=(cfg.epsilon_initial, cfg.epsilon_final,
                                  cfg.epsilon_decay_steps)))
        self.learner = _QLearner(self.obs_dim, self.num_actions, cfg,
                                 cfg.model_hidden, cfg.seed,
                                 device=cfg.device)
        self.buffer = ReplayBuffer(cfg.replay_buffer_capacity,
                                   seed=cfg.seed)
        self.workers.sync_weights(self.learner.get_weights())

    def _after_update(self) -> None:
        if self.learner.num_updates % self.config.target_update_freq == 0:
            self.learner.sync_target()
