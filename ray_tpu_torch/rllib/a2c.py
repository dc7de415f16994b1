"""A2C: synchronous advantage actor-critic (port of ray_tpu/rllib/a2c.py).

PPO's synchronous sample / update plumbing with the plain
policy-gradient loss: no ratio clipping, one pass over the whole batch
(`sgd_minibatch_size` 0 means the whole train batch).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ray_tpu_torch.rllib.learner import TorchLearner, policy_terms
from ray_tpu_torch.rllib.learner_group import learner_for
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def a2c_loss(model, mb, cfg) -> Tuple[torch.Tensor, Dict]:
    """-(logp * normalized advantage) + vf_coeff * squared value error -
    ent_coeff * entropy, over categorical actions."""
    vf_coeff = cfg.get("vf_loss_coeff", 0.5)
    ent_coeff = cfg.get("entropy_coeff", 0.0)
    values, logp, adv, entropy = policy_terms(model, mb, cfg)
    policy_loss = -(logp * adv).mean()
    vf_loss = ((values - mb[SampleBatch.VALUE_TARGETS]) ** 2).mean()
    total = policy_loss + vf_coeff * vf_loss - ent_coeff * entropy
    return total, {"total_loss": total, "policy_loss": policy_loss,
                   "vf_loss": vf_loss, "entropy": entropy}


class A2CConfig(PPOConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = A2C
        # On-policy single pass, as in the reference A2C.
        self.num_sgd_iter = 1
        self.sgd_minibatch_size = 0   # 0 = whole batch
        self.train_batch_size = 2048
        self.lr = 1e-3
        self.entropy_coeff = 0.01


class A2C(PPO):
    def _make_learner(self):
        cfg = self.config
        mb = cfg.sgd_minibatch_size or cfg.train_batch_size
        return learner_for(
            TorchLearner, self.obs_dim, self.num_actions, loss_fn=a2c_loss,
            config={"lr": cfg.lr, "grad_clip": cfg.grad_clip,
                    "num_sgd_iter": cfg.num_sgd_iter,
                    "sgd_minibatch_size": mb,
                    "vf_loss_coeff": getattr(cfg, "vf_loss_coeff", 0.5),
                    "entropy_coeff": getattr(cfg, "entropy_coeff", 0.0)},
            hidden=cfg.model_hidden, seed=cfg.seed, device=cfg.device,
            mesh=cfg.learner_mesh)
