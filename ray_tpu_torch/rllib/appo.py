"""APPO: asynchronous PPO (port of ray_tpu/rllib/appo.py).

IMPALA's async actor-learner architecture with PPO's clipped
importance-ratio surrogate on the V-trace advantages: the config's
`clip_param` switches `_VTraceLearner`'s policy loss to the clipped
surrogate against the behaviour policy.  Like IMPALA it needs the
caller's runtime handle (`.resources(runtime=...)`).
"""

from __future__ import annotations

from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = APPO
        # The reference's defaults (lr / clip tuned on its CartPole gate).
        self.clip_param = 0.2
        self.lr = 3e-4
        self.entropy_coeff = 0.005
        self.min_updates_per_step = 4


class APPO(IMPALA):
    """All behaviour inherited: the config's clip_param engages the
    clipped surrogate inside the V-trace learner."""
