"""In-place weight publication: put once, adopt by reference (port of
ray_tpu/rl/weights.py, with the runtime and the Observer injected).

The learner's weights cross the process boundary exactly once per
version boundary — one `runtime.put` into the object plane — and every
rollout actor receives the REFERENCE (`actor.adopt.remote(version,
ref)`).  The publisher remembers the current (version, ref) pair so a
re-formed rollout worker can re-adopt the live weights without a fresh
put (`re_adopt`).

`runtime` is the caller's handle (`put`, `get`; the `ray_tpu` module).
The driver-side put + fan-out is one `rl/publish` span; the counters are
the reference's `rl_weight_publishes`, `rl_weight_adoptions` and the
histogram `rl_weight_publish_s`.  As in the reference,
`rl_weight_adoptions` counts only adoptions the driver waited for
(`wait=True`, `re_adopt`); each actor's own `rl/adopt` span goes to that
actor's observer, which a remote actor does not share with the driver.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence, Tuple

from ray_tpu_torch.util.observe import NOOP, Observer


class WeightPublisher:
    """Driver-side fan-out of learner weights to a rollout gang."""

    def __init__(self, runtime: Any, observer: Optional[Observer] = None):
        self.runtime = runtime
        self._obs = observer or NOOP
        self.version = 0
        self._ref: Any = None

    def publish(self, weights: Any, actors: Sequence[Any], *,
                version: Optional[int] = None,
                wait: bool = True) -> Tuple[int, List[Any]]:
        """Put `weights` once and fan the reference to `actors`.

        Returns (version, failed_actors): adoption failures (dead
        actors) are collected, not raised, so the controller can replace
        the worker and `re_adopt` the replacement.  With wait=False the
        adopt calls are left in flight."""
        t0 = time.monotonic()
        self.version = (int(version) if version is not None
                        else self.version + 1)
        failed: List[Any] = []
        with self._obs.span("rl", "publish", version=self.version,
                            actors=len(actors)):
            self._ref = self.runtime.put(weights)
            refs = [(a, a.adopt.remote(self.version, self._ref))
                    for a in actors]
            if wait:
                for a, ref in refs:
                    try:
                        self.runtime.get(ref)
                        self._obs.inc("rl_weight_adoptions")
                    except Exception:   # a dead actor: the caller replaces
                        failed.append(a)
        self._obs.inc("rl_weight_publishes")
        self._obs.observe("rl_weight_publish_s", time.monotonic() - t0)
        return self.version, failed

    def re_adopt(self, actor: Any) -> int:
        """Hand the CURRENT (version, ref) to one actor — the re-formed
        rollout worker path.  No new put."""
        if self._ref is None:
            raise RuntimeError("nothing published yet")
        self.runtime.get(actor.adopt.remote(self.version, self._ref))
        self._obs.inc("rl_weight_adoptions")
        return self.version
