"""Augmented Random Search (Mania et al. 2018; port of
ray_tpu/rllib/ars.py).

The V1-t / V2-t variants: only the top-b directions (by best-of-pair
return, ordered by numpy's argsort so ties fall as in the reference)
contribute, the step is normalized by the std of the surviving returns,
and V2 normalizes observations with a running mean/std filter folded
from the worker fleet's moments.  Shares the evaluation worker with ES
(es.py): seed-coded antithetic perturbations, one population forward on
the device per env step.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.es import ES, _noise


class ARSConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=ARS)
        self.num_rollout_workers = 2
        self.episodes_per_batch = 16     # directions sampled per iter
        self.top_directions = 8          # b: directions kept for the step
        self.noise_stdev = 0.05
        self.lr = 0.02
        self.episode_horizon = 500
        self.observation_filter = "MeanStdFilter"   # "NoFilter" = V1
        self.model_hidden = (32,)


class ARS(ES):
    def setup(self) -> None:
        super().setup()
        # V2 observation filter state (aggregated across the fleet).
        self._obs_n = 1e-4
        self._obs_sum = np.zeros(self.obs_dim, np.float64)
        self._obs_sq = np.full(self.obs_dim, 1e-4, np.float64)

    def _obs_stats(self):
        if self.config.observation_filter != "MeanStdFilter":
            return None
        mean = self._obs_sum / self._obs_n
        var = np.maximum(self._obs_sq / self._obs_n - mean ** 2, 1e-8)
        return mean.astype(np.float32), np.sqrt(var).astype(np.float32)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n_dir = cfg.episodes_per_batch
        b = min(cfg.top_directions, n_dir)
        seeds = self._rng.integers(0, 2 ** 31 - 1, size=n_dir)
        results, shards = self._fan_out(seeds, self._obs_stats())
        r_plus = np.concatenate([r["r_plus"] for r in results])
        r_minus = np.concatenate([r["r_minus"] for r in results])
        used = np.concatenate(shards)
        # Fold the fleet's observation moments into the running filter.
        for r in results:
            self._obs_n += r["obs_n"]
            self._obs_sum += r["obs_sum"]
            self._obs_sq += r["obs_sq"]
        # Top-b directions by best-of-pair (V1-t/V2-t selection).
        order = np.argsort(-np.maximum(r_plus, r_minus))[:b]
        kept = np.concatenate([r_plus[order], r_minus[order]])
        sigma_r = kept.std() + 1e-8
        eps = np.stack([_noise(used[i], self.theta.size) for i in order])
        step = ((r_plus[order] - r_minus[order])[:, None] * eps).sum(0)
        self.theta += cfg.lr / (b * sigma_r) * step
        return {"episodes_this_iter": self._record(results, r_plus, r_minus),
                "sigma_r": float(sigma_r),
                "theta_norm": float(np.linalg.norm(self.theta))}

    def save_to_dict(self) -> Dict[str, Any]:
        d = super().save_to_dict()
        d.update({"obs_n": self._obs_n, "obs_sum": self._obs_sum.copy(),
                  "obs_sq": self._obs_sq.copy()})
        return d

    def restore_from_dict(self, state: Dict[str, Any]) -> None:
        super().restore_from_dict(state)
        self._obs_n = state["obs_n"]
        self._obs_sum = np.array(state["obs_sum"])
        self._obs_sq = np.array(state["obs_sq"])
