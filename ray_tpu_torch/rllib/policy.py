"""Rollout policies: action sampling + weight get/set, shared by workers
and learners (port of ray_tpu/rllib/policy.py): `TorchPolicy`
(categorical or diagonal-Gaussian actions), SAC's
`SquashedGaussianRolloutPolicy`, TD3's `DeterministicNoiseRolloutPolicy`
and the LSTM's `RecurrentTorchPolicy`.

Weights cross the object plane as the reference's tree of numpy arrays
(`get_weights`: flax's variables, or the recurrent model's plain dict),
so a reference learner's weights can be
adopted by a port worker and the other way round.  The reference pins a
rollout policy to the host CPU (`force_cpu=True`); here the placement is
the explicit `device` (None -> CUDA; the config forwards its
`rollout_device`).  Sampling draws from a `torch.Generator` on that
device made from `seed + 1`, so a draw is the port's own, not
`jax.random`'s: the tests hold greedy actions exactly and the log-probs
of the port's own draws.
"""

from __future__ import annotations

import threading
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib.models import (gaussian_logp,
                                        make_continuous_model, make_model,
                                        make_offpolicy_model,
                                        make_recurrent_model)


def to_tensor(x, device: torch.device) -> torch.Tensor:
    """An observation batch on `device`: uint8 images stay bytes (the
    conv model scales them on the device), everything else float32."""
    t = torch.as_tensor(np.asarray(x))
    if t.dtype != torch.uint8:
        t = t.float()
    return t.to(device)


def _gumbel_argmax(logits: torch.Tensor, gen: torch.Generator):
    """A categorical draw over the logits and its log-prob."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp_(min=torch.finfo(u.dtype).tiny)
    action = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
    logp = torch.log_softmax(logits, dim=-1).gather(
        -1, action[:, None])[:, 0]
    return action, logp


def _numpy(*tensors):
    return tuple(t.cpu().numpy() for t in tensors)


class _WeightsMixin:
    """get_weights / set_weights as the reference's tree of numpy arrays
    (flax's variables tree, or the recurrent model's plain dict), under
    the policy's lock: set_weights may arrive from another thread (an
    actor's calls) while compute_actions reads the model."""

    def get_weights(self) -> Any:
        with self._lock:
            return convert.actor_critic_variables(self.model)

    def set_weights(self, weights: Any) -> None:
        """Adopt the reference's tree (numpy or tensor leaves), from a
        port learner or a reference one."""
        sd = convert.actor_critic_state_dict(weights, self.model)
        with self._lock:
            self.model.load_state_dict(sd)


class TorchPolicy(_WeightsMixin):
    """Policy over an actor-critic: categorical actions, or with
    `num_actions == 0` and `action_dim > 0` a diagonal Gaussian over the
    continuous actions (`GaussianActorCritic`)."""

    def __init__(self, obs_dim, num_actions: int,
                 hidden: Sequence[int] = (64, 64), seed: int = 0,
                 device: DeviceLike = None, action_dim: int = 0,
                 action_low: float = -1.0, action_high: float = 1.0):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.continuous = num_actions == 0 and action_dim > 0
        self.action_dim = action_dim
        self.action_low, self.action_high = action_low, action_high
        self.device = resolve_device(device)
        if self.continuous:
            self.model = make_continuous_model(
                obs_dim, action_dim, hidden, seed=seed, device=self.device)
        else:
            self.model = make_model(obs_dim, num_actions, hidden,
                                    seed=seed, device=self.device)
        self._gen = torch.Generator(self.device).manual_seed(seed + 1)
        self._lock = threading.Lock()

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, explore: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
        """Returns (actions, logp, vf_preds, logits) as numpy: with
        `explore` a draw and its log-prob, else the greedy action and
        zeros.  Continuous: the draw is mean + std * N(0, 1), unclipped
        (the stored action and its logp describe the same point; the env
        clips at step time), the greedy action the mean clipped to the
        bounds, and the means stand in the logits' slot."""
        x = to_tensor(obs, self.device)
        if self.continuous:
            with self._lock:
                mean, log_std, value = self.model(x)
            if explore:
                noise = torch.randn(mean.shape, generator=self._gen,
                                    device=self.device)
                action = mean + torch.exp(log_std) * noise
                logp = gaussian_logp(mean, log_std, action)
            else:
                action = torch.clamp(mean, self.action_low,
                                     self.action_high)
                logp = torch.zeros(len(x), device=self.device)
            return _numpy(action, logp, value, mean)
        with self._lock:
            logits, value = self.model(x)
        if explore:
            action, logp = _gumbel_argmax(logits, self._gen)
        else:
            action = torch.argmax(logits, dim=-1)
            logp = torch.zeros(len(x), device=self.device)
        return _numpy(action, logp, value, logits)

    def value(self, obs: np.ndarray) -> np.ndarray:
        _, _, v, _ = self.compute_actions(obs)
        return v


class _ContinuousRolloutPolicy(_WeightsMixin):
    """Shared shell of the off-policy continuous rollout policies: an
    actor network on `device`, actions in env scale
    (tanh-or-actor output * scale + center).  compute_actions matches
    TorchPolicy's interface; the logp and value slots are zeros (the
    off-policy learners never read them)."""

    def __init__(self, kind: str, obs_dim: int, action_dim: int, hidden,
                 seed: int, action_low, action_high, device: DeviceLike):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.continuous = True
        self.device = resolve_device(device)
        self.model = make_offpolicy_model(kind, obs_dim, action_dim, hidden,
                                          seed=seed, device=self.device)
        self._gen = torch.Generator(self.device).manual_seed(seed + 1)
        self._lock = threading.Lock()
        low, high = np.asarray(action_low), np.asarray(action_high)
        self._scale = float((high - low) / 2.0)
        self._center = float((high + low) / 2.0)
        self._low, self._high = float(low), float(high)

    def value(self, obs: np.ndarray) -> np.ndarray:
        return np.zeros(len(obs), np.float32)

    def _out(self, action, mean):
        z = np.zeros(len(action), np.float32)
        a, m = _numpy(action, mean)
        return a, z, z, m


class SquashedGaussianRolloutPolicy(_ContinuousRolloutPolicy):
    """SAC's behaviour policy: a = tanh(mean + std * N(0, 1)) * scale +
    center; greedy, tanh(mean) in env scale."""

    def __init__(self, obs_dim: int, action_dim: int, hidden=(256, 256),
                 seed: int = 0, action_low: float = -1.0,
                 action_high: float = 1.0, device: DeviceLike = None):
        super().__init__("squashed", obs_dim, action_dim, hidden, seed,
                         action_low, action_high, device)

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, explore: bool = True):
        x = to_tensor(obs, self.device)
        with self._lock:
            mean, log_std = self.model(x)
        u = mean
        if explore:
            u = mean + torch.exp(log_std) * torch.randn(
                mean.shape, generator=self._gen, device=self.device)
        return self._out(torch.tanh(u) * self._scale + self._center, mean)


class DeterministicNoiseRolloutPolicy(_ContinuousRolloutPolicy):
    """TD3's behaviour policy: a = clip(actor(s) * scale + center +
    N(0, (noise_scale * scale)^2), bounds); without `explore` the noise's
    sigma is 0 (a draw is still taken, as the reference splits its key
    either way)."""

    def __init__(self, obs_dim: int, action_dim: int, hidden=(256, 256),
                 seed: int = 0, action_low: float = -1.0,
                 action_high: float = 1.0, device: DeviceLike = None,
                 noise_scale: float = 0.1):
        super().__init__("deterministic", obs_dim, action_dim, hidden, seed,
                         action_low, action_high, device)
        self.noise_scale = noise_scale

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, explore: bool = True):
        x = to_tensor(obs, self.device)
        with self._lock:
            a = self.model(x) * self._scale + self._center
        sigma = self.noise_scale if explore else 0.0
        noise = sigma * self._scale * torch.randn(
            a.shape, generator=self._gen, device=self.device)
        return self._out(torch.clamp(a + noise, self._low, self._high), a)


class RecurrentTorchPolicy(_WeightsMixin):
    """LSTM actor-critic policy with explicit state threading:
    compute_actions takes and returns the recurrent state [2, B, H]; the
    rollout worker owns the per-env state and zeroes it at episode
    boundaries."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64,), lstm_size: int = 64,
                 seed: int = 0, device: DeviceLike = None):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.continuous = False
        self.lstm_size = lstm_size
        self.device = resolve_device(device)
        self.model = make_recurrent_model(obs_dim, num_actions, hidden,
                                          lstm_size, seed=seed,
                                          device=self.device)
        self.initial_state = self.model.initial_state
        self._gen = torch.Generator(self.device).manual_seed(seed + 1)
        self._lock = threading.Lock()

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, state: np.ndarray,
                        explore: bool = True):
        """(actions, logp, vf, logits, state_out) as numpy; state_out is
        a writable [2, B, H] array of the host's own."""
        x = to_tensor(obs, self.device)
        st = torch.as_tensor(np.asarray(state, np.float32)).to(self.device)
        with self._lock:
            logits, value, state_out = self.model.step(x, st)
        if explore:
            action, logp = _gumbel_argmax(logits, self._gen)
        else:
            action = torch.argmax(logits, dim=-1)
            logp = torch.zeros(len(x), device=self.device)
        return _numpy(action, logp, value, logits, state_out)
