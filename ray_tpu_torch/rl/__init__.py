"""ray_tpu_torch.rl — the Podracer-style split actor/learner RL substrate
(port of ray_tpu/rl/).

- Rollout gangs (`rollout.py`): versioned trajectories through the
  port's `InferenceEngine` (`EngineRolloutActor`, behaviour log-probs
  captured, K4 on every decode step) or through the vectorized-env
  `RolloutWorker` (`EnvRolloutActor`).
- In-place weight publication (`weights.py`): one put per version
  boundary, adopted by reference; engine actors swap between scheduler
  steps without dropping in-flight lanes.
- A stale-tolerant V-trace learner (`learner.py`) fed by a bounded
  `TrajectoryQueue` (`trajectory.py`), with COMMITTED checkpoints in the
  reference's format.

`controller.py` wires them into the async loop (`PodracerConfig()
.resources(runtime=ray_tpu).build()`).  The runtime and the Observer are
passed in by the caller; nothing here imports `ray_tpu`.
"""

from ray_tpu_torch.rl.controller import Podracer, PodracerConfig  # noqa: F401
from ray_tpu_torch.rl.learner import StaleTolerantLearner  # noqa: F401
from ray_tpu_torch.rl.rollout import (  # noqa: F401
    EngineRolloutActor, EnvRolloutActor)
from ray_tpu_torch.rl.trajectory import TrajectoryQueue  # noqa: F401
from ray_tpu_torch.rl.weights import WeightPublisher  # noqa: F401
