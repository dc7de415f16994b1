"""Bounded, staleness-aware trajectory queue between rollouts and learner
(the port's copy of ray_tpu/rl/trajectory.py, with an injected Observer).

The queue is driver-local (it lives in the controller, not in the
learner), which is what lets a killed learner resume from a checkpoint
without poisoning it: entries are (batch, behavior_version) pairs, and
staleness is evaluated against the CURRENT learner version at admission
and again at consumption — a batch that was fresh when queued but went
stale while the learner was down is evicted, never trained on.

Two protections, both recorded on the `rl` plane of the caller's
`Observer` (`stale_drop` and `backpressure` events; the counters
`rl_trajectories_accepted`, `rl_trajectories_stale_dropped`,
`rl_trajectory_backpressure`):

- staleness bound: a batch whose behavior version trails the learner by
  more than `staleness_bound` versions is rejected;
- capacity: when the queue is full the producer is backpressured
  instead of growing an unbounded staleness ramp.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Optional, Tuple

from ray_tpu_torch.util.observe import NOOP, Observer


class TrajectoryQueue:
    """Thread-safe bounded FIFO of (batch, behavior_version) entries."""

    def __init__(self, capacity: int = 8, staleness_bound: int = 1,
                 observer: Optional[Observer] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if staleness_bound < 0:
            raise ValueError(
                f"staleness_bound must be >= 0, got {staleness_bound}")
        self.capacity = int(capacity)
        self.staleness_bound = int(staleness_bound)
        self._obs = observer or NOOP
        self._dq: "collections.deque[Tuple[Any, int]]" = collections.deque()
        self._cv = threading.Condition()
        self.accepted = 0
        self.stale_dropped = 0
        self.backpressured = 0

    def __len__(self) -> int:
        with self._cv:
            return len(self._dq)

    @property
    def full(self) -> bool:
        with self._cv:
            return len(self._dq) >= self.capacity

    def put(self, batch: Any, version: int, learner_version: int,
            timeout: float = 0.0) -> bool:
        """Offer one batch produced by policy `version`.  Returns False
        (and records why) when the batch is already staler than the
        bound or the queue stays full past `timeout` — the caller
        should treat False-with-full as backpressure and hold the
        producer instead of re-offering in a spin."""
        staleness = int(learner_version) - int(version)
        if staleness > self.staleness_bound:
            self.stale_dropped += 1
            self._obs.inc("rl_trajectories_stale_dropped")
            self._obs.record("rl", "stale_drop", version=int(version),
                          learner_version=int(learner_version),
                          staleness=staleness, where="put")
            return False
        with self._cv:
            if not self._cv.wait_for(
                    lambda: len(self._dq) < self.capacity,
                    timeout=timeout):
                self.backpressured += 1
                self._obs.inc("rl_trajectory_backpressure")
                self._obs.record("rl", "backpressure", depth=len(self._dq),
                              capacity=self.capacity)
                return False
            self._dq.append((batch, int(version)))
            self.accepted += 1
            self._obs.inc("rl_trajectories_accepted")
            self._cv.notify_all()
            return True

    def get(self, learner_version: int,
            timeout: float = 0.0) -> Optional[Tuple[Any, int]]:
        """Pop the oldest batch still within the staleness bound for the
        CURRENT learner version; entries that went stale while queued
        are evicted in passing.  None when nothing consumable arrives
        within `timeout`."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._cv:
            while True:
                while self._dq:
                    batch, version = self._dq.popleft()
                    staleness = int(learner_version) - version
                    if staleness <= self.staleness_bound:
                        self._cv.notify_all()
                        return batch, version
                    self.stale_dropped += 1
                    self._obs.inc("rl_trajectories_stale_dropped")
                    self._obs.record("rl", "stale_drop", version=version,
                                  learner_version=int(learner_version),
                                  staleness=staleness, where="get")
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait_for(
                        lambda: bool(self._dq), timeout=remaining):
                    return None

    def evict_stale(self, learner_version: int) -> int:
        """Drop every queued entry beyond the staleness bound (the
        learner-resume path calls this so a restored learner never
        consumes trajectories from before its checkpoint horizon)."""
        dropped = 0
        with self._cv:
            keep = collections.deque()
            for batch, version in self._dq:
                if int(learner_version) - version <= self.staleness_bound:
                    keep.append((batch, version))
                else:
                    dropped += 1
                    self.stale_dropped += 1
                    self._obs.inc("rl_trajectories_stale_dropped")
                    self._obs.record(
                        "rl", "stale_drop", version=version,
                        learner_version=int(learner_version),
                        staleness=int(learner_version) - version,
                        where="evict")
            self._dq = keep
            if dropped:
                self._cv.notify_all()
        return dropped

    def stats(self) -> dict:
        with self._cv:
            return {"depth": len(self._dq), "capacity": self.capacity,
                    "staleness_bound": self.staleness_bound,
                    "accepted": self.accepted,
                    "stale_dropped": self.stale_dropped,
                    "backpressured": self.backpressured}
