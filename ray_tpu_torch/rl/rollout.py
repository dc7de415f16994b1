"""Rollout actors: versioned trajectory generation (port of
ray_tpu/rl/rollout.py).

Two gang members, one contract — `adopt(version, weights)` swaps the
policy in place and `rollout()` / `sample_versioned()` emits
trajectories TAGGED with the policy version that produced them:

- `EngineRolloutActor` generates through the port's `InferenceEngine`
  with `capture_logp=True`, so every emitted token carries the
  behaviour log-prob V-trace needs; continuous batching, the prefix
  cache of the shared prompt template and speculative decoding (a pure
  throughput multiplier, token-exact) ride along.  Every T=1 decode
  step runs the paged-decode kernel (K4).
- `EnvRolloutActor` is the vectorized-env `RolloutWorker` in time-major
  V-trace layout, version-tagged the same way.

Weight adoption on the engine path is BETWEEN scheduler steps
(`InferenceEngine.update_params`): in-flight lanes keep their paged-KV
state and continue under the new weights.  Weights arrive in either
package's layout: the reference's params as numpy, or the port's
tensors.  Spans go to the caller's `Observer` (`rl/adopt`,
`rl/rollout`).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.inference import InferenceEngine
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.util.observe import NOOP, Observer


class EngineRolloutActor:
    """Trajectory generation through the serving engine, in-process or
    as an actor of the caller's runtime; `device=None` means CUDA."""

    def __init__(self, model="gpt", config="nano", *, params=None,
                 max_lanes: int = 4, spec_k: int = 0,
                 temperature: float = 1.0, seed: int = 0,
                 prefix_cache: bool = True,
                 reward_fn: Optional[Callable[[List[int], List[int]],
                                              float]] = None,
                 device: DeviceLike = None,
                 observer: Optional[Observer] = None, **engine_kwargs):
        self._obs = observer or NOOP
        self.engine = InferenceEngine(
            model, config, params, max_lanes=max_lanes, spec_k=spec_k,
            seed=seed, prefix_cache=prefix_cache, auto_start=False,
            capture_logp=True, device=device, observer=observer,
            **engine_kwargs)
        self.temperature = float(temperature)
        self.version = 0
        self._reward_fn = reward_fn
        self._total_tokens = 0

    # -- weights -----------------------------------------------------------
    def adopt(self, version: int, weights: Any) -> int:
        """In-place weight swap: live lanes keep generating.  `weights`
        is the reference's param tree (numpy) or the port's tensors."""
        eng = self.engine
        with self._obs.span("rl", "adopt", version=int(version),
                            live_lanes=eng.num_active):
            eng.update_params(convert.params_from_numpy(
                weights, eng.config, eng.device), int(version))
        self.version = int(version)
        return self.version

    def get_version(self) -> int:
        return self.version

    # -- sampling ----------------------------------------------------------
    def rollout(self, prompts: Sequence[Sequence[int]],
                max_new_tokens: int = 32,
                seed: Optional[int] = None
                ) -> Tuple[SampleBatch, int, Dict]:
        """Generate one trajectory per prompt; all prompts ride the lane
        scheduler concurrently (finished lanes are refilled from the
        queue mid-flight).

        Returns (batch, version, metrics): `batch` is a time-major
        [T, B] SampleBatch of token trajectories (right-padded to the
        longest episode, `valid` masks the padding) and `version` is the
        policy version EVERY token in it was sampled under."""
        t0 = time.monotonic()
        version = self.version
        with self._obs.span("rl", "rollout", version=version,
                            prompts=len(prompts)):
            handles = [
                self.engine.submit(
                    list(p), max_new_tokens, temperature=self.temperature,
                    seed=None if seed is None else seed + i)
                for i, p in enumerate(prompts)]
            while self.engine.step():
                pass
            episodes = [(h.tokens(), h.logps) for h in handles]
        B = len(episodes)
        T = max(1, max(len(toks) for toks, _ in episodes))
        actions = np.zeros((T, B), np.int32)
        logp = np.zeros((T, B), np.float32)
        rewards = np.zeros((T, B), np.float32)
        terminateds = np.zeros((T, B), np.bool_)
        valid = np.zeros((T, B), np.bool_)
        tokens_out = 0
        for b, ((toks, lps), prompt) in enumerate(zip(episodes, prompts)):
            n = len(toks)
            tokens_out += n
            actions[:n, b] = toks
            logp[:n, b] = lps
            valid[:n, b] = True
            if n:
                terminateds[n - 1, b] = True
                if self._reward_fn is not None:
                    rewards[n - 1, b] = float(
                        self._reward_fn(list(prompt), toks))
        self._total_tokens += tokens_out
        batch = SampleBatch({
            SampleBatch.ACTIONS: actions,
            SampleBatch.ACTION_LOGP: logp,
            SampleBatch.REWARDS: rewards,
            SampleBatch.TERMINATEDS: terminateds,
            SampleBatch.TRUNCATEDS: np.zeros((T, B), np.bool_),
            "valid": valid,
            "policy_version": np.full((T, B), version, np.int32),
        })
        wall = time.monotonic() - t0
        st = self.engine.stats()
        metrics = {"tokens": tokens_out, "wall_s": wall,
                   "tokens_per_s": tokens_out / wall if wall > 0 else 0.0,
                   "total_tokens": self._total_tokens,
                   "prefix_hit_tokens": st["prefix_hit_tokens"],
                   "spec_accepted_per_step": st["spec_accepted_per_step"]}
        return batch, version, metrics

    def stats(self) -> dict:
        return self.engine.stats()

    def ping(self) -> bool:
        return True


class EnvRolloutActor(RolloutWorker):
    """Vectorized-env rollout worker with version tagging.

    Always collects in the time-major V-trace layout (postprocess is
    forced off); `sample_versioned()` is `sample()` plus the policy
    version the fragment was collected under.
    """

    def __init__(self, *args, observer: Optional[Observer] = None,
                 **kwargs):
        kwargs["postprocess"] = False
        super().__init__(*args, **kwargs)
        self._obs = observer or NOOP
        self.version = 0

    def adopt(self, version: int, weights: Any) -> int:
        with self._obs.span("rl", "adopt", version=int(version)):
            self.set_weights(weights)
        self.version = int(version)
        return self.version

    def get_version(self) -> int:
        return self.version

    def sample_versioned(self) -> Tuple[SampleBatch, int, Dict]:
        version = self.version
        with self._obs.span("rl", "rollout", version=version):
            batch, metrics = self.sample()
        T, B = batch[SampleBatch.ACTIONS].shape[:2]
        batch["policy_version"] = np.full((T, B), version, np.int32)
        return batch, version, metrics
