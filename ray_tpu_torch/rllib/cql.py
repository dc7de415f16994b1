"""CQL: Conservative Q-Learning for offline RL, discrete actions (port
of ray_tpu/rllib/cql.py).

Single-Q TD against a target network's max (DQN-style bootstrapping)
plus the CQL(H) regularizer cql_alpha * E[logsumexp_a Q(s, a) - Q(s,
a_logged)], which pushes Q down on actions the behaviour policy never
logged.  The Q-network is the reference's `ActorCritic`, its logits head
read as Q-values.  The target is a copy of the network, synced every
`target_update_interval` steps; never an alias (the port updates the
network in place, so an alias would follow every step).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.rllib.dqn import frozen_copy
from ray_tpu_torch.rllib.offline import OfflineLearner
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class CQLConfig:
    def __init__(self):
        self.cql_alpha = 1.0       # conservative penalty weight (0 = TD)
        self.gamma = 0.99
        self.lr = 5e-4
        self.train_batch_size = 256
        self.num_epochs = 1
        self.target_update_interval = 50   # in update steps
        self.model_hidden = (64, 64)
        self.seed = 0


class CQL(OfflineLearner):
    """Offline trainer over logged transitions (obs, action, reward,
    next_obs via the following row or an explicit column, done)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 config: Optional[CQLConfig] = None, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(obs_dim, num_actions, config or CQLConfig(),
                         device=device, generator=generator)
        self.num_actions = num_actions
        self.target = frozen_copy(self.model)
        self._steps = 0

    @torch.no_grad()
    def sync_target(self) -> None:
        for t, p in zip(self.target.parameters(), self.model.parameters()):
            t.copy_(p)

    def loss(self, obs, actions, rewards, next_obs, dones):
        """(td + cql_alpha * conservative, td, conservative)."""
        cfg = self.config
        q, _ = self.model(obs)                              # [B, A]
        q_a = q.gather(1, actions[:, None])[:, 0]
        with torch.no_grad():
            q_next, _ = self.target(next_obs)
            target = rewards + cfg.gamma * (1.0 - dones) * \
                q_next.max(-1).values
        td = ((q_a - target) ** 2).mean()
        # CQL(H): logsumexp over all actions minus the logged action's Q,
        # minimized when out-of-support actions score below the data's.
        conservative = (torch.logsumexp(q, -1) - q_a).mean()
        return td + cfg.cql_alpha * conservative, td, conservative

    def train_on(self, batch: SampleBatch) -> Dict[str, float]:
        """Run `num_epochs` of minibatch CQL updates over a logged batch.

        Input contract: rows are time-ordered transitions, episodes laid
        out back to back, with done flags (terminateds | truncateds)
        marking each episode's last row.  next_obs for row t is row t+1's
        obs, which is valid because a done row's bootstrap is masked by
        (1 - dones), so the splice across an episode boundary is never
        read.  Shuffled or subsampled logs must carry an explicit
        "next_obs" column instead.  Ragged columns raise, and so does a
        "next_obs" column of another row count.
        """
        cfg = self.config
        obs = np.asarray(batch[SampleBatch.OBS], np.float32)
        actions = np.asarray(batch[SampleBatch.ACTIONS])
        rewards = np.asarray(batch[SampleBatch.REWARDS], np.float32)
        if len(obs) == 0:
            raise ValueError("CQL.train_on: empty batch")
        if not (len(actions) == len(rewards) == len(obs)):
            raise ValueError(
                "CQL.train_on: ragged batch (obs/actions/rewards rows "
                f"{len(obs)}/{len(actions)}/{len(rewards)})")
        term = np.asarray(batch.get(SampleBatch.TERMINATEDS,
                                    np.zeros(len(obs))), bool)
        trunc = np.asarray(batch.get(SampleBatch.TRUNCATEDS,
                                     np.zeros(len(obs))), bool)
        dones = (term | trunc)
        if "next_obs" in batch:
            # Explicit column: no ordering assumption needed.
            next_obs = np.asarray(batch["next_obs"], np.float32)
            if len(next_obs) != len(obs):
                raise ValueError("CQL.train_on: next_obs rows "
                                 f"{len(next_obs)} != obs rows {len(obs)}")
        else:
            # next_obs = the following row inside an episode; a done row
            # bootstraps nothing, so its next_obs is arbitrary (masked).
            next_obs = np.concatenate([obs[1:], obs[-1:]], 0)
            dones[-1] = True   # the log's tail cannot bootstrap
        cols = (self._tensor(obs), self._tensor(actions, torch.long),
                self._tensor(rewards), self._tensor(next_obs),
                self._tensor(dones, torch.float32))
        aux = None
        for idx in self._minibatches(len(obs)):
            aux = self.loss(*(c[idx] for c in cols))
            self._apply(aux[0])
            self._steps += 1
            if self._steps % cfg.target_update_interval == 0:
                self.sync_target()
        last = dict(zip(("total_loss", "td_loss", "cql_loss"),
                        torch.stack(aux).detach().cpu().tolist()))
        last["samples"] = len(obs)
        return last

    def q_values(self, obs: np.ndarray) -> np.ndarray:
        return self._logits(obs).cpu().numpy()
