"""TorchPolicy: action sampling + weight get/set, shared by workers and
learners (port of ray_tpu/rllib/policy.py's `JaxPolicy`, discrete
actions).

Weights cross the object plane as the reference's: a flax variables tree
of numpy arrays (`get_weights`), so a reference learner's weights can be
adopted by a port worker and the other way round.  The reference pins a
rollout policy to the host CPU (`force_cpu=True`); here the placement is
the explicit `device` (None -> CUDA; the config forwards its
`rollout_device`).  Sampling draws from a `torch.Generator` on that
device made from `seed + 1`.

Continuous (Gaussian, squashed, deterministic) and recurrent policies
wait for their algorithms (ROADMAP A9).
"""

from __future__ import annotations

import threading
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib.models import make_model


def to_tensor(x, device: torch.device) -> torch.Tensor:
    """An observation batch on `device`: uint8 images stay bytes (the
    conv model scales them on the device), everything else float32."""
    t = torch.as_tensor(np.asarray(x))
    if t.dtype != torch.uint8:
        t = t.float()
    return t.to(device)


class TorchPolicy:
    """Categorical-action policy over an actor-critic model."""

    def __init__(self, obs_dim, num_actions: int,
                 hidden: Sequence[int] = (64, 64), seed: int = 0,
                 device: DeviceLike = None):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.continuous = False
        self.device = resolve_device(device)
        self.model = make_model(obs_dim, num_actions, hidden, seed=seed,
                                device=self.device)
        self._gen = torch.Generator(self.device).manual_seed(seed + 1)
        # set_weights may arrive from another thread (an actor's calls)
        # while compute_actions reads the model.
        self._lock = threading.Lock()

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, explore: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
        """Returns (actions, logp, vf_preds, logits) as numpy: with
        `explore` a categorical draw (the Gumbel argmax over the logits)
        and its log-prob, else the greedy action and zeros."""
        x = to_tensor(obs, self.device)
        with self._lock:
            logits, value = self.model(x)
        if explore:
            u = torch.rand(logits.shape, generator=self._gen,
                           device=self.device)
            u = u.clamp_(min=torch.finfo(u.dtype).tiny)
            action = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
            logp = torch.log_softmax(logits, dim=-1).gather(
                -1, action[:, None])[:, 0]
        else:
            action = torch.argmax(logits, dim=-1)
            logp = torch.zeros(len(x), device=self.device)
        a, lp, v, lg = (t.cpu().numpy() for t in (action, logp, value,
                                                  logits))
        return a, lp.astype(np.float32), v, lg

    def value(self, obs: np.ndarray) -> np.ndarray:
        _, _, v, _ = self.compute_actions(obs)
        return v

    def get_weights(self) -> Any:
        """The weights as the reference's flax variables tree (numpy)."""
        with self._lock:
            return convert.actor_critic_variables(self.model)

    def set_weights(self, weights: Any) -> None:
        """Adopt a flax variables tree (numpy or tensor leaves) — from a
        port learner or a reference one."""
        sd = convert.actor_critic_state_dict(weights, self.model)
        with self._lock:
            self.model.load_state_dict(sd)
