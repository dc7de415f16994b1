"""Replay buffers for off-policy RL (the port's copy of
ray_tpu/rllib/replay_buffer.py, numpy only).

`ReplayBuffer` is a uniform FIFO ring over SampleBatch rows;
`PrioritizedReplayBuffer` samples proportionally to priority**alpha over
the priority array in one numpy pass, with importance weights
(N * P(i))**-beta normalized by their max.  Both draw from
`np.random.default_rng(seed)` in the reference's order, so the same seed
samples the same rows in either package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform FIFO ring buffer over SampleBatch rows."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = capacity
        self._rng = np.random.default_rng(seed)
        self._storage: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch) -> None:
        n = batch.count
        if not self._storage:
            for k, v in batch.items():
                self._storage[k] = np.zeros((self.capacity,) + v.shape[1:],
                                            v.dtype)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._storage[k][idx] = v
        self._next = (self._next + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int) -> SampleBatch:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return SampleBatch({k: v[idx] for k, v in self._storage.items()})


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference:
    prioritized_replay_buffer.py): P(i) ~ p_i^alpha, importance weights
    w_i = (N * P(i))^-beta normalized by max."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self._priorities = np.zeros(capacity, np.float64)
        self._max_priority = 1.0

    def add(self, batch: SampleBatch) -> None:
        n = batch.count
        idx = (self._next + np.arange(n)) % self.capacity
        super().add(batch)
        self._priorities[idx] = self._max_priority

    def sample(self, batch_size: int, beta: float = 0.4) -> SampleBatch:
        prios = self._priorities[:self._size] ** self.alpha
        probs = prios / prios.sum()
        idx = self._rng.choice(self._size, size=batch_size, p=probs)
        weights = (self._size * probs[idx]) ** (-beta)
        weights /= weights.max()
        out = SampleBatch({k: v[idx] for k, v in self._storage.items()})
        out["weights"] = weights.astype(np.float32)
        out["batch_indexes"] = idx.astype(np.int64)
        return out

    def update_priorities(self, idx: np.ndarray,
                          priorities: np.ndarray) -> None:
        priorities = np.abs(priorities) + 1e-6
        self._priorities[idx] = priorities
        self._max_priority = max(self._max_priority,
                                 float(priorities.max()))
