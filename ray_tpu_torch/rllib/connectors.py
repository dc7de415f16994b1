"""Connectors: composable transforms between env and policy (the port's
copy of ray_tpu/rllib/connectors.py, numpy only).

Agent connectors transform observations on the way INTO the policy,
action connectors the policy's output on the way OUT to the env
(reference: rllib/connectors/).  Every transform is one numpy op over
the env batch, the reference's arithmetic line for line.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class Connector:
    def __call__(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class ConnectorPipeline(Connector):
    """Ordered composition (reference: connectors/connector_pipeline_v2)."""

    def __init__(self, connectors: Optional[List[Connector]] = None):
        self.connectors = list(connectors or [])

    def append(self, c: Connector) -> "ConnectorPipeline":
        self.connectors.append(c)
        return self

    def __call__(self, x):
        for c in self.connectors:
            x = c(x)
        return x


# -- agent (observation) connectors ----------------------------------------

class FlattenObs(Connector):
    """[B, ...] -> [B, prod(...)] (reference: FlattenObservations)."""

    def __call__(self, obs):
        obs = np.asarray(obs)
        return obs.reshape(obs.shape[0], -1)


class NormalizeObs(Connector):
    """Running mean/std observation filter (reference: MeanStdFilter,
    rllib/utils/filter.py) with Welford updates over env batches."""

    def __init__(self, clip: float = 10.0, update: bool = True):
        self.clip = clip
        self.update = update
        self._count = 1e-4
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def __call__(self, obs):
        obs = np.asarray(obs, np.float64)
        if self._mean is None:
            self._mean = np.zeros(obs.shape[1:])
            self._m2 = np.ones(obs.shape[1:])
        if self.update:
            b = len(obs)
            bmean = obs.mean(0)
            bvar = obs.var(0)
            delta = bmean - self._mean
            tot = self._count + b
            self._mean = self._mean + delta * b / tot
            self._m2 = (self._m2 * self._count + bvar * b
                        + delta ** 2 * self._count * b / tot)
            self._m2 /= tot
            self._count = tot
        std = np.sqrt(self._m2) + 1e-8
        out = (obs - self._mean) / std
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    # Filters travel with weights so remote workers normalize identically.
    def get_state(self):
        return {"count": self._count, "mean": self._mean, "m2": self._m2}

    def set_state(self, st):
        self._count = st["count"]
        self._mean = st["mean"]
        self._m2 = st["m2"]


class ClipObs(Connector):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def __call__(self, obs):
        return np.clip(obs, self.low, self.high)


# -- action connectors ------------------------------------------------------

class ClipActions(Connector):
    """Clip continuous actions to env bounds (reference:
    connectors/action/ clip_actions — the env must never see
    out-of-range samples even though training stores the raw ones)."""

    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def __call__(self, actions):
        return np.clip(actions, self.low, self.high)


class UnsquashActions(Connector):
    """[-1, 1] policy output -> env bounds (reference: unsquash_actions)."""

    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def __call__(self, actions):
        a = np.asarray(actions)
        return self.low + (a + 1.0) * 0.5 * (self.high - self.low)
