"""PPO: Proximal Policy Optimization (port of ray_tpu/rllib/ppo.py,
single-agent).

training_step: synchronous sampling until train_batch_size rows ->
minibatch SGD (`TorchLearner`) -> one weight broadcast.  The loss
follows the model: `ppo_loss_recurrent` with `use_lstm` (rows are then
sequences), `ppo_loss_continuous` on a continuous env, else `ppo_loss`.
Multi-agent configs wait for `multi_agent.py` (ROADMAP A9).
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import (TorchLearner, ppo_loss,
                                         ppo_loss_continuous,
                                         ppo_loss_recurrent)
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
        recurrent = ({"policy_kind": "recurrent", "lstm_size": cfg.lstm_size}
                     if cfg.use_lstm else {})
        self.workers = WorkerSet(
            num_workers=cfg.num_rollout_workers, runtime=cfg.runtime,
            num_cpus_per_worker=cfg.num_cpus_per_worker,
            worker_kwargs=self.worker_kwargs(postprocess=True, **recurrent))
        self.learner = self._make_learner()
        self.workers.sync_weights(self.learner.get_weights())

    def _make_learner(self) -> TorchLearner:
        """Overridable learner factory (A2C swaps the loss and config
        here)."""
        cfg = self.config
        if cfg.use_lstm:
            loss = ppo_loss_recurrent
        elif self.continuous:
            loss = ppo_loss_continuous
        else:
            loss = ppo_loss
        return TorchLearner(
            self.obs_dim, self.num_actions, action_dim=self.action_dim,
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
            hidden=cfg.model_hidden, seed=cfg.seed, device=cfg.device)

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
        train_batch = SampleBatch.concat_samples(batches)
        # 2. Minibatch SGD.
        learner_metrics = self.learner.update(train_batch)
        # 3. Weight broadcast via the object store.
        self.workers.sync_weights(self.learner.get_weights())
        return {"sampled_rows": train_batch.count,
                "episodes_this_iter": episodes,
                **{f"learner/{k}": v for k, v in learner_metrics.items()}}

    def save_to_dict(self) -> Dict[str, Any]:
        return {"learner_state": self.learner.get_state(),
                "config": self.config.to_dict()}

    def restore_from_dict(self, state: Dict[str, Any]) -> None:
        self.learner.set_state(state["learner_state"])
        self.workers.sync_weights(self.learner.get_weights())
