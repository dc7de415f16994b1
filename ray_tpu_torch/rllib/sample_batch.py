"""SampleBatch: the experience container moved between rollout workers and
learners (the port's copy of ray_tpu/rllib/sample_batch.py, numpy only).

Columns are numpy arrays with a shared leading dimension: what crosses
the object plane between processes is plain numpy, in the port as in the
reference, so a batch either package's workers emit trains in the
other's learner.  `compute_gae` is the reference's GAE recursion over
time-major fragments.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class SampleBatch(dict):
    """A dict of columns (numpy arrays) with equal leading dimension."""

    OBS = "obs"
    ACTIONS = "actions"
    REWARDS = "rewards"
    TERMINATEDS = "terminateds"
    TRUNCATEDS = "truncateds"
    ACTION_LOGP = "action_logp"
    ACTION_LOGITS = "action_logits"
    VF_PREDS = "vf_preds"
    ADVANTAGES = "advantages"
    VALUE_TARGETS = "value_targets"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, np.ndarray):
                self[k] = np.asarray(v)

    @property
    def count(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    def __len__(self) -> int:  # len(batch) == row count, as in the reference
        return self.count

    def shuffle(self, rng: np.random.Generator) -> "SampleBatch":
        perm = rng.permutation(self.count)
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def to_minibatches(self, minibatch_size: int) -> Iterator["SampleBatch"]:
        n = (self.count // minibatch_size) * minibatch_size
        for i in range(0, n, minibatch_size):
            yield self.slice(i, i + minibatch_size)

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch(
            {k: np.concatenate([b[k] for b in batches], axis=0) for k in keys})

    def size_bytes(self) -> int:
        return sum(v.nbytes for v in self.values())


def compute_gae(rewards: np.ndarray, values: np.ndarray, dones: np.ndarray,
                bootstrap_value: np.ndarray, gamma: float, lam: float):
    """Generalized Advantage Estimation over time-major fragments.

    rewards/values/dones: [T, B]; bootstrap_value: [B] (value of the obs
    after the last step, used when the fragment ends mid-episode).
    Returns (advantages, value_targets), both [T, B].

    Reference behavior: rllib/evaluation/postprocessing.py
    (compute_advantages, use_gae=True).
    """
    T = rewards.shape[0]
    advantages = np.zeros_like(rewards, dtype=np.float32)
    not_done = 1.0 - dones.astype(np.float32)
    next_value = bootstrap_value.astype(np.float32)
    gae = np.zeros_like(next_value)
    for t in range(T - 1, -1, -1):
        delta = rewards[t] + gamma * next_value * not_done[t] - values[t]
        gae = delta + gamma * lam * not_done[t] * gae
        advantages[t] = gae
        next_value = values[t]
    value_targets = advantages + values.astype(np.float32)
    return advantages, value_targets
