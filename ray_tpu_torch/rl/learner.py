"""Stale-tolerant V-trace learner with COMMITTED checkpoints (port of
ray_tpu/rl/learner.py).

Wraps the port's V-trace SGD core (`rllib.impala._VTraceLearner`) with
what the async actor/learner loop needs on top of plain IMPALA:

- an explicit POLICY VERSION that advances only at publish boundaries
  (`publish_boundary()`), so trajectory staleness is a well-defined
  `learner.version - behavior_version`;
- per-update staleness accounting (the `rl_update_staleness` histogram;
  the `rl/learn` span carries the staleness it trained on);
- durable state through the port's `CheckpointManager`: COMMITTED
  checkpoints of the reference's tree {"params", "opt_state", "version",
  "num_updates"} (flax params, optax's namedtuple skeleton), so either
  package's learner resumes from the other's save.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.checkpoint import CheckpointManager
from ray_tpu_torch.rllib.impala import IMPALAConfig, _VTraceLearner
from ray_tpu_torch.util.observe import NOOP, Observer


class StaleTolerantLearner:
    def __init__(self, obs_dim, num_actions: int, *,
                 hidden=(64, 64), gamma: float = 0.99, lr: float = 6e-4,
                 grad_clip: float = 40.0, vf_loss_coeff: float = 0.5,
                 entropy_coeff: float = 0.01,
                 clip_rho_threshold: float = 1.0,
                 clip_c_threshold: float = 1.0, seed: int = 0,
                 ckpt_dir: Optional[str] = None, ckpt_interval: int = 20,
                 keep_last_k: int = 3, device: DeviceLike = None,
                 observer: Optional[Observer] = None):
        cfg = IMPALAConfig()
        cfg.gamma = gamma
        cfg.lr = lr
        cfg.grad_clip = grad_clip
        cfg.vf_loss_coeff = vf_loss_coeff
        cfg.entropy_coeff = entropy_coeff
        cfg.clip_rho_threshold = clip_rho_threshold
        cfg.clip_c_threshold = clip_c_threshold
        self._core = _VTraceLearner(obs_dim, num_actions, cfg, hidden, seed,
                                    device=device)
        self.device = self._core.device
        self._obs = observer or NOOP
        self.version = 1          # the initial weights ARE version 1
        self.num_updates = 0
        self.ckpt_interval = int(ckpt_interval)
        self._ckpt = None
        if ckpt_dir is not None:
            self._ckpt = CheckpointManager(ckpt_dir, keep_last_k=keep_last_k,
                                           observer=observer)

    # -- training ----------------------------------------------------------
    def update(self, batch, behavior_version: int) -> Dict[str, float]:
        """One V-trace SGD step on a batch collected under
        `behavior_version`.  `valid` and `policy_version` are dropped
        before the loss, which (as the reference's) does not mask by
        `valid`."""
        staleness = self.version - int(behavior_version)
        self._obs.observe("rl_update_staleness", float(max(0, staleness)))
        train = {k: v for k, v in batch.items()
                 if k not in ("policy_version", "valid")}
        with self._obs.span("rl", "learn", version=self.version,
                            staleness=staleness):
            metrics = self._core.update(train)
        self.num_updates += 1
        self._obs.inc("rl_learner_updates")
        if (self._ckpt is not None and self.ckpt_interval > 0
                and self.num_updates % self.ckpt_interval == 0):
            self.checkpoint()
        metrics["staleness"] = float(staleness)
        return metrics

    def publish_boundary(self) -> Tuple[int, Any]:
        """Advance the policy version and hand out the weights to
        publish under it."""
        self.version += 1
        return self.version, self._core.get_weights()

    def get_weights(self):
        return self._core.get_weights()

    # -- durability --------------------------------------------------------
    def state_tree(self) -> Dict[str, Any]:
        state = self._core.get_state()
        return {"params": state["params"], "opt_state": state["opt_state"],
                "version": np.asarray(self.version, np.int64),
                "num_updates": np.asarray(self.num_updates, np.int64)}

    def checkpoint(self, *, sync: bool = True) -> None:
        """COMMITTED save at the current update count (sync by default:
        a checkpoint the learner reported is one it can resume from)."""
        if self._ckpt is None:
            raise RuntimeError("learner built without ckpt_dir")
        self._ckpt.save(self.num_updates, self.state_tree(), sync=sync)

    def restore_latest(self) -> Optional[int]:
        """Resume from the newest COMMITTED checkpoint (the port's or the
        reference's); None when there is none.  Returns the restored
        update count."""
        if self._ckpt is None or self._ckpt.latest_step() is None:
            return None
        tree = self._ckpt.restore(device=self.device)
        self.set_state_tree(tree)
        self._obs.record("rl", "learner_resume", version=self.version,
                         num_updates=self.num_updates)
        return self.num_updates

    def set_state_tree(self, tree: Dict[str, Any]) -> None:
        """Load a `state_tree()` of either package."""
        self._core.set_state({"params": tree["params"],
                              "opt_state": tree["opt_state"]})
        self.version = int(tree["version"])
        self.num_updates = int(tree["num_updates"])
