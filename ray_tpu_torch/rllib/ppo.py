"""PPO: Proximal Policy Optimization (port of ray_tpu/rllib/ppo.py).

training_step: synchronous sampling until train_batch_size rows ->
minibatch SGD (`TorchLearner`) -> one weight broadcast.  The loss
follows the model: `ppo_loss_recurrent` with `use_lstm` (rows are then
sequences), `ppo_loss_continuous` on a continuous env, else `ppo_loss`.

With `.multi_agent(...)` the workers are `MultiAgentRolloutWorker`s,
each policy has its own `TorchLearner`, every policy's rows train its
learner, the whole policy map is broadcast in one put, and the result
carries `policy_reward_mean/<pid>` and `learner/<pid>/<metric>`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import (TorchLearner, ppo_loss,
                                         ppo_loss_continuous,
                                         ppo_loss_recurrent)
from ray_tpu_torch.rllib.learner_group import learner_for
from ray_tpu_torch.rllib.multi_agent import (MultiAgentBatch,
                                             MultiAgentRolloutWorker)
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.rllib.worker_set import WorkerSet


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=PPO)
        self.clip_param = 0.2
        self.vf_clip_param = 100.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.005
        self.lr = 5e-4
        self.train_batch_size = 4096
        self.sgd_minibatch_size = 256
        self.num_sgd_iter = 10


class PPO(Algorithm):
    def setup(self) -> None:
        cfg = self.config
        if self.multi_agent:
            self.workers = WorkerSet(
                num_workers=cfg.num_rollout_workers, runtime=cfg.runtime,
                num_cpus_per_worker=cfg.num_cpus_per_worker,
                worker_cls=MultiAgentRolloutWorker,
                worker_kwargs=self.worker_kwargs(
                    policies=dict.fromkeys(cfg.policies),
                    policy_mapping_fn=cfg.policy_mapping_fn))
            # One learner per policy.
            self.learners = {pid: self._make_learner(spec)
                             for pid, spec in self.policy_specs.items()}
            self.workers.sync_weights(self._policy_weights())
            return
        recurrent = ({"policy_kind": "recurrent", "lstm_size": cfg.lstm_size}
                     if cfg.use_lstm else {})
        self.workers = WorkerSet(
            num_workers=cfg.num_rollout_workers, runtime=cfg.runtime,
            num_cpus_per_worker=cfg.num_cpus_per_worker,
            worker_kwargs=self.worker_kwargs(postprocess=True, **recurrent))
        self.learner = self._make_learner()
        self.workers.sync_weights(self.learner.get_weights())

    def _policy_weights(self) -> Dict[str, Any]:
        return {pid: ln.get_weights() for pid, ln in self.learners.items()}

    def _make_learner(self, spec=None):
        """Overridable learner factory (A2C swaps the loss and config
        here): a `TorchLearner`, or a learner group of them under a
        `learner_mesh`.  `spec` = (obs_dim, num_actions) of a
        multi-agent policy."""
        cfg = self.config
        obs_dim, num_actions = spec if spec else (self.obs_dim,
                                                  self.num_actions)
        if cfg.use_lstm:
            loss = ppo_loss_recurrent
        elif self.continuous:
            loss = ppo_loss_continuous
        else:
            loss = ppo_loss
        return learner_for(
            TorchLearner, obs_dim, num_actions, action_dim=self.action_dim,
            model="lstm" if cfg.use_lstm else "fc",
            lstm_size=cfg.lstm_size, loss_fn=loss,
            config={
                "lr": cfg.lr, "grad_clip": cfg.grad_clip,
                "num_sgd_iter": cfg.num_sgd_iter,
                "sgd_minibatch_size": cfg.sgd_minibatch_size,
                "clip_param": getattr(cfg, "clip_param", 0.2),
                "vf_clip_param": getattr(cfg, "vf_clip_param", 100.0),
                "vf_loss_coeff": getattr(cfg, "vf_loss_coeff", 0.5),
                "entropy_coeff": getattr(cfg, "entropy_coeff", 0.0),
            },
            hidden=cfg.model_hidden, seed=cfg.seed, device=cfg.device,
            mesh=cfg.learner_mesh)

    def training_step(self) -> Dict[str, Any]:
        # 1. Synchronous parallel sampling until train_batch_size rows.
        batches, all_metrics = [], []
        rows = 0
        while rows < self.config.train_batch_size:
            bs, ms = self.workers.sample_sync()
            batches.extend(bs)
            all_metrics.extend(ms)
            rows += sum(b.count for b in bs)
        episodes = self._record_metrics(all_metrics)
        if self.multi_agent:
            return self._multi_agent_step(batches, all_metrics, episodes)
        train_batch = SampleBatch.concat_samples(batches)
        # 2. Minibatch SGD.
        learner_metrics = self.learner.update(train_batch)
        # 3. Weight broadcast via the object store.
        self.workers.sync_weights(self.learner.get_weights())
        return {"sampled_rows": train_batch.count,
                "episodes_this_iter": episodes,
                **{f"learner/{k}": v for k, v in learner_metrics.items()}}

    def _multi_agent_step(self, batches, all_metrics, episodes):
        train_batch = MultiAgentBatch.concat_samples(batches)
        # 2. Per-policy minibatch SGD.
        learner_metrics = {}
        for pid, sub in train_batch.policy_batches.items():
            for k, v in self.learners[pid].update(sub).items():
                learner_metrics[f"{pid}/{k}"] = v
        # 3. Broadcast the whole policy map in one put.
        self.workers.sync_weights(self._policy_weights())
        # Per-policy improvement signal for multi-agent gates.
        per_policy_returns: Dict[str, list] = {}
        mapping = self.config.policy_mapping_fn or (lambda a: a)
        for m in all_metrics:
            for aid, rs in m.get("per_agent_returns", {}).items():
                per_policy_returns.setdefault(mapping(aid), []).extend(rs)
        extra = {f"policy_reward_mean/{pid}": float(np.mean(rs))
                 for pid, rs in per_policy_returns.items() if rs}
        return {"sampled_rows": train_batch.count,
                "episodes_this_iter": episodes, **extra,
                **{f"learner/{k}": v for k, v in learner_metrics.items()}}

    def save_to_dict(self) -> Dict[str, Any]:
        if self.multi_agent:
            return {"learner_state": {pid: ln.get_state()
                                      for pid, ln in self.learners.items()},
                    "config": self.config.to_dict()}
        return {"learner_state": self.learner.get_state(),
                "config": self.config.to_dict()}

    def restore_from_dict(self, state: Dict[str, Any]) -> None:
        if self.multi_agent:
            for pid, st in state["learner_state"].items():
                self.learners[pid].set_state(st)
            self.workers.sync_weights(self._policy_weights())
            return
        self.learner.set_state(state["learner_state"])
        self.workers.sync_weights(self.learner.get_weights())
