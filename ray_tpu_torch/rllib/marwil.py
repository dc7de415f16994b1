"""MARWIL: Monotonic Advantage Re-Weighted Imitation Learning (port of
ray_tpu/rllib/marwil.py).

Exponentially advantage-weighted behavior cloning over logged
trajectories: L = E[min(exp(beta * A / c), max_weight) * -log pi(a|s)]
+ vf_coeff * E[A^2], with A = (Monte-Carlo return) - V(s) from the
jointly trained critic (no gradient through A into the weight) and c the
square root of a running moment of A^2, updated on the host after every
minibatch as the reference updates it.  beta 0 is plain BC.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.rllib.offline import OfflineLearner, nll
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def compute_mc_returns(rewards: np.ndarray, dones: np.ndarray,
                       gamma: float) -> np.ndarray:
    """Per-row discounted Monte-Carlo return-to-go within each logged
    episode (episode boundaries = done rows)."""
    out = np.zeros(len(rewards), np.float32)
    acc = 0.0
    for i in range(len(rewards) - 1, -1, -1):
        if dones[i]:
            acc = 0.0
        acc = rewards[i] + gamma * acc
        out[i] = acc
    return out


class MARWILConfig:
    def __init__(self):
        self.beta = 1.0            # 0 = BC
        self.vf_coeff = 1.0
        self.gamma = 0.99
        self.lr = 1e-3
        self.train_batch_size = 256
        self.num_epochs = 1
        self.model_hidden = (64, 64)
        self.max_weight = 20.0     # clip the exp advantage weight
        self.seed = 0


class MARWIL(OfflineLearner):
    def __init__(self, obs_dim: int, num_actions: int,
                 config: Optional[MARWILConfig] = None, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(obs_dim, num_actions, config or MARWILConfig(),
                         device=device, generator=generator)
        # c^2: the running moment of squared advantages.
        self.adv_norm_sq = 1.0

    def loss(self, obs, actions, returns, adv_norm: float):
        """(total, policy loss, vf loss, the advantages held fixed)."""
        cfg = self.config
        logits, values = self.model(obs)
        adv = returns - values
        # The weight uses the current advantage but pushes no gradient
        # through the critic into the actor term.
        w = torch.clamp(torch.exp(cfg.beta * adv.detach() / adv_norm),
                        max=cfg.max_weight)
        policy_loss = (w * nll(logits, actions)).mean()
        vf_loss = (adv ** 2).mean()
        return (policy_loss + cfg.vf_coeff * vf_loss, policy_loss, vf_loss,
                adv.detach())

    def train_on(self, batch: SampleBatch) -> Dict[str, float]:
        cfg = self.config
        obs = np.asarray(batch[SampleBatch.OBS], np.float32)
        actions = np.asarray(batch[SampleBatch.ACTIONS])
        rewards = np.asarray(batch[SampleBatch.REWARDS], np.float32)
        term = np.asarray(batch.get(SampleBatch.TERMINATEDS,
                                    np.zeros(len(obs))), bool)
        trunc = np.asarray(batch.get(SampleBatch.TRUNCATEDS,
                                     np.zeros(len(obs))), bool)
        if obs.ndim > 2:
            obs = obs.reshape(-1, obs.shape[-1])
            actions, rewards = actions.reshape(-1), rewards.reshape(-1)
            term, trunc = term.reshape(-1), trunc.reshape(-1)
        returns = compute_mc_returns(rewards, term | trunc, cfg.gamma)
        obs_t, act_t = self._tensor(obs), self._tensor(actions, torch.long)
        ret_t = self._tensor(returns)
        last = {}
        for idx in self._minibatches(len(obs)):
            c = float(np.sqrt(self.adv_norm_sq)) + 1e-8
            total, policy_loss, vf_loss, adv = self.loss(
                obs_t[idx], act_t[idx], ret_t[idx], c)
            self._apply(total)
            # One host copy a minibatch: the losses and the advantages
            # whose E[A^2] moves the running moment, as numpy computes it.
            host = torch.cat([torch.stack([total, policy_loss, vf_loss])
                              .detach(), adv]).cpu().numpy()
            self.adv_norm_sq += 1e-2 * (
                float(np.mean(host[3:] ** 2)) - self.adv_norm_sq)
            last = {"total_loss": float(host[0]),
                    "policy_loss": float(host[1]),
                    "vf_loss": float(host[2])}
        last["samples"] = len(obs)
        return last
