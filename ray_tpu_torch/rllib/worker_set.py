"""WorkerSet: the actor fleet of RolloutWorkers (port of
ray_tpu/rllib/worker_set.py).

The reference calls `ray_tpu.remote`, `put`, `get` and `kill` directly;
the port imports no `ray_tpu`, so the caller passes a runtime handle: any
object with those attributes (and `wait`), duck-typed — callers and tests
pass the `ray_tpu` module itself.  Without one there are no remote
workers: `num_workers` must be 0 and sampling runs in the local worker
(the reference's num_workers=0 mode).

Failed workers are detected on RPC error, replaced, and the fleet keeps
going, as in the reference; a round in which every worker fails
_MAX_FAILED_ROUNDS times in a row raises.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.rllib import env as env_mod
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.sample_batch import SampleBatch

logger = logging.getLogger("ray_tpu_torch.rllib")

# Rounds in a row with zero surviving workers before a deterministic
# failure is surfaced instead of replacing workers forever.
_MAX_FAILED_ROUNDS = 3


class WorkerSet:
    def __init__(self, *, num_workers: int, worker_kwargs: Dict[str, Any],
                 runtime: Any = None, num_cpus_per_worker: float = 1,
                 worker_cls: type = RolloutWorker):
        if num_workers and runtime is None:
            raise ValueError(
                f"{num_workers} remote rollout workers need a runtime "
                f"handle (e.g. config.resources(runtime=ray_tpu)); "
                f"without one use num_rollout_workers=0")
        worker_kwargs = dict(worker_kwargs, env=env_mod.shippable_env(
            worker_kwargs.get("env")))
        self.runtime = runtime
        self._worker_kwargs = worker_kwargs
        self._consecutive_failed_rounds = 0
        self._remote_cls = (runtime.remote(num_cpus=num_cpus_per_worker)(
            worker_cls) if num_workers else None)
        self._workers: List[Any] = [
            self._make_worker(i) for i in range(num_workers)]
        # The local worker evaluates and holds canonical weights alongside
        # the learner (reference: WorkerSet.local_worker()).
        self.local_worker = worker_cls(**worker_kwargs)

    def _make_worker(self, index: int):
        kwargs = dict(self._worker_kwargs)
        kwargs["seed"] = kwargs.get("seed", 0) + 1000 * (index + 1)
        return self._remote_cls.remote(**kwargs)

    @property
    def num_remote_workers(self) -> int:
        return len(self._workers)

    def sync_weights(self, weights: Optional[Any] = None) -> None:
        """Broadcast weights to every remote worker via one object-store
        put (reference: worker_set.py:384)."""
        if weights is None:
            weights = self.local_worker.get_weights()
        else:
            self.local_worker.set_weights(weights)
        if not self._workers:
            return
        ref = self.runtime.put(weights)
        self._foreach_with_recovery(lambda w: w.set_weights.remote(ref))

    def sample_sync(self) -> Tuple[List[SampleBatch], List[Dict]]:
        """One synchronous sampling round across all remote workers; with
        zero remote workers, from the local worker."""
        if not self._workers:
            batch, metrics = self.local_worker.sample()
            return [batch], [metrics]
        results = self._foreach_with_recovery(lambda w: w.sample.remote())
        return [b for b, _ in results], [m for _, m in results]

    def _foreach_with_recovery(self, fn) -> List[Any]:
        refs = [(i, fn(w)) for i, w in enumerate(self._workers)]
        results: List[Any] = []
        failed: List[int] = []
        last_error: Optional[Exception] = None
        for i, ref in refs:
            try:
                results.append(self.runtime.get(ref))
            except Exception as e:  # actor died: replace and continue
                logger.warning("rollout worker %d failed: %s", i, e)
                failed.append(i)
                last_error = e
        if results or not refs:
            self._consecutive_failed_rounds = 0
        else:
            self._consecutive_failed_rounds += 1
            if self._consecutive_failed_rounds >= _MAX_FAILED_ROUNDS:
                raise RuntimeError(
                    f"all {len(refs)} rollout workers failed "
                    f"{self._consecutive_failed_rounds} rounds in a row; "
                    f"last error: {last_error!r}") from last_error
        for i in failed:
            self._workers[i] = self._make_worker(i)
            try:
                ref = self.runtime.put(self.local_worker.get_weights())
                self.runtime.get(self._workers[i].set_weights.remote(ref))
            except Exception as e:   # surfaces at its next call
                logger.warning("replacement worker %d: %s", i, e)
        return results

    def replace_worker(self, worker) -> Any:
        """Replace a specific (failed) worker actor; returns the new one."""
        i = self._workers.index(worker)
        self._workers[i] = self._make_worker(i)
        return self._workers[i]

    def stop(self) -> None:
        for w in self._workers:
            try:
                self.runtime.kill(w)
            except Exception as e:     # already gone
                logger.debug("kill: %s", e)
        self._workers = []

    @property
    def remote_workers(self) -> List[Any]:
        return list(self._workers)
