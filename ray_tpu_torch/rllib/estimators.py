"""Off-policy estimators: evaluate a target policy from logged data
(port of ray_tpu/rllib/estimators.py).

Per-decision importance sampling (IS), weighted IS (cumulative ratios
normalized by their batch mean at each step), the direct method (DM: a
fitted Q-model queried under the target policy) and doubly robust (DR:
the control-variate combination of both), in numpy as the reference
computes them; `fit_fqe` (fitted Q evaluation) trains its Q-model in
torch on `device` (None -> CUDA).

All estimators consume a logged SampleBatch with episode boundaries
(terminateds | truncateds), behavior log-probs (ACTION_LOGP) and rewards,
plus a `target_probs_fn(obs) -> [N, A]` giving the target policy's action
distribution.  DM/DR additionally need `q_fn(obs) -> [N, A]`.
Results: v_behavior / v_target / v_gain.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.models import make_model
from ray_tpu_torch.rllib.sac import plain_adam
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def split_episodes(batch: SampleBatch) -> List[Dict[str, np.ndarray]]:
    """Cut a row-major logged batch into per-episode dicts at
    terminated|truncated boundaries (trailing partial episode kept)."""
    done = (np.asarray(batch[SampleBatch.TERMINATEDS], bool)
            | np.asarray(batch[SampleBatch.TRUNCATEDS], bool))
    ends = np.flatnonzero(done) + 1
    bounds = [0, *ends.tolist()]
    if bounds[-1] != len(done):
        bounds.append(len(done))
    keys = list(batch.keys())
    return [{k: np.asarray(batch[k])[a:b] for k in keys}
            for a, b in zip(bounds[:-1], bounds[1:])]


class OffPolicyEstimator:
    """Base: per-episode estimates averaged over the batch."""

    def __init__(self, target_probs_fn: Callable, gamma: float = 0.99,
                 q_fn: Optional[Callable] = None):
        self.target_probs_fn = target_probs_fn
        self.gamma = gamma
        self.q_fn = q_fn

    # -- subclass hook -----------------------------------------------------
    def estimate_episode(self, ep: Dict[str, np.ndarray],
                         rho: np.ndarray) -> float:
        raise NotImplementedError

    # -- shared machinery --------------------------------------------------
    def _ratios(self, ep: Dict[str, np.ndarray]) -> np.ndarray:
        """Per-step importance ratios pi(a|s) / b(a|s)."""
        probs = np.asarray(self.target_probs_fn(ep[SampleBatch.OBS]))
        acts = ep[SampleBatch.ACTIONS].astype(int)
        pi = probs[np.arange(len(acts)), acts]
        b = np.exp(ep[SampleBatch.ACTION_LOGP])
        return pi / np.maximum(b, 1e-12)

    # Subclasses that never read the importance ratios (DM) skip the
    # per-episode target-policy forward pass entirely.
    needs_ratios = True

    def estimate(self, batch: SampleBatch) -> Dict[str, float]:
        episodes = split_episodes(batch)
        # One forward pass per episode, shared by _prepare AND the
        # per-episode estimates (WIS used to pay it twice).
        rhos = ([self._ratios(ep) for ep in episodes]
                if self.needs_ratios else [None] * len(episodes))
        self._prepare(episodes, rhos)
        v_behavior, v_target = [], []
        for ep, rho in zip(episodes, rhos):
            g = self.gamma ** np.arange(len(ep[SampleBatch.REWARDS]))
            v_behavior.append(float((g * ep[SampleBatch.REWARDS]).sum()))
            v_target.append(self.estimate_episode(ep, rho))
        vb = float(np.mean(v_behavior))
        vt = float(np.mean(v_target))
        return {"v_behavior": vb, "v_target": vt, "v_gain": vt - vb,
                "episodes": len(episodes)}

    def _prepare(self, episodes, rhos) -> None:
        """Batch-level pre-pass (WIS normalization constants)."""


class ImportanceSampling(OffPolicyEstimator):
    """Per-decision IS: V = E[ sum_t gamma^t (prod_{u<=t} rho_u) r_t ]."""

    def estimate_episode(self, ep, rho):
        p = np.cumprod(rho)
        g = self.gamma ** np.arange(len(p))
        return float((g * p * ep[SampleBatch.REWARDS]).sum())


class WeightedImportanceSampling(OffPolicyEstimator):
    """WIS: cumulative ratios are normalized by their MEAN over the
    batch's episodes at each step index — biased but far lower
    variance."""

    def _prepare(self, episodes, rhos) -> None:
        max_t = max((len(e[SampleBatch.REWARDS]) for e in episodes),
                    default=0)
        sums = np.zeros(max_t)
        counts = np.zeros(max_t)
        for rho in rhos:
            p = np.cumprod(rho)
            sums[:len(p)] += p
            counts[:len(p)] += 1
        self._w = sums / np.maximum(counts, 1)

    def estimate_episode(self, ep, rho):
        p = np.cumprod(rho)
        w = np.maximum(self._w[:len(p)], 1e-12)
        g = self.gamma ** np.arange(len(p))
        return float((g * (p / w) * ep[SampleBatch.REWARDS]).sum())


class DirectMethod(OffPolicyEstimator):
    """DM: the fitted Q-model's value of the target policy at episode
    starts, V = E_{a ~ pi}[Q(s_0, a)]; any q_fn(obs) -> [N, A] plugs in,
    fit_fqe() below provides one."""

    needs_ratios = False

    def estimate_episode(self, ep, rho):
        obs0 = ep[SampleBatch.OBS][:1]
        q = np.asarray(self.q_fn(obs0))[0]
        pi = np.asarray(self.target_probs_fn(obs0))[0]
        return float((pi * q).sum())


class DoublyRobust(OffPolicyEstimator):
    """DR: backward recursion
    V_t = vhat(s_t) + rho_t (r_t + gamma V_{t+1} - Q(s_t, a_t)),
    estimate = mean V_0 — unbiased if EITHER the ratios or the Q-model
    are correct."""

    def estimate_episode(self, ep, rho):
        obs = ep[SampleBatch.OBS]
        acts = ep[SampleBatch.ACTIONS].astype(int)
        q = np.asarray(self.q_fn(obs))            # [T, A]
        pi = np.asarray(self.target_probs_fn(obs))
        vhat = (pi * q).sum(-1)                   # [T]
        q_taken = q[np.arange(len(acts)), acts]
        v_next = 0.0
        for t in range(len(acts) - 1, -1, -1):
            v_next = vhat[t] + rho[t] * (
                ep[SampleBatch.REWARDS][t] + self.gamma * v_next
                - q_taken[t])
        return float(v_next)


ESTIMATORS = {
    "is": ImportanceSampling,
    "wis": WeightedImportanceSampling,
    "dm": DirectMethod,
    "dr": DoublyRobust,
}


def fit_fqe(batch: SampleBatch, target_probs_fn: Callable,
            num_actions: int, gamma: float = 0.99,
            iterations: int = 200, lr: float = 1e-2,
            hidden=(64,), seed: int = 0, device: DeviceLike = None,
            generator: Optional[torch.Generator] = None) -> Callable:
    """Fitted Q Evaluation: learn Q^pi of the target policy from logged
    transitions by bootstrapped regression, one full-batch plain-Adam
    step an iteration on `device` (None -> CUDA); the bootstrap reads the
    current network without a gradient.  The Q-model is the
    `ActorCritic`'s logits head, its weights drawn from `generator` (a CPU
    torch.Generator), or else from one seeded with `seed`.  Returns
    q_fn(obs) -> [N, A] (numpy) for DM/DR."""
    dev = resolve_device(device)
    obs_np = np.asarray(batch[SampleBatch.OBS], np.float32)
    model = make_model(obs_np.shape[-1], num_actions, hidden, seed=seed,
                       device=dev, generator=generator)
    opt = plain_adam(model.parameters(), lr)

    obs = torch.as_tensor(obs_np, device=dev)
    acts = torch.as_tensor(np.asarray(batch[SampleBatch.ACTIONS]),
                           dtype=torch.long, device=dev)
    rew = torch.as_tensor(np.asarray(batch[SampleBatch.REWARDS]),
                          dtype=torch.float32, device=dev)
    done = torch.as_tensor(
        np.asarray(batch[SampleBatch.TERMINATEDS], bool)
        | np.asarray(batch[SampleBatch.TRUNCATEDS], bool),
        dtype=torch.float32, device=dev)
    next_np = np.concatenate([obs_np[1:], obs_np[-1:]], 0)
    next_obs = torch.as_tensor(next_np, device=dev)
    pi_next = torch.as_tensor(np.asarray(target_probs_fn(next_np)),
                              dtype=torch.float32, device=dev)

    for _ in range(iterations):
        q, _ = model(obs)              # the fcnet head as Q-values
        q_sa = q.gather(1, acts[:, None])[:, 0]
        with torch.no_grad():
            v_next = (pi_next * model(next_obs)[0]).sum(-1)
            target = rew + gamma * (1.0 - done) * v_next
        loss = ((q_sa - target) ** 2).mean()
        opt.step(torch.autograd.grad(loss, opt.params,
                                     materialize_grads=True))

    @torch.no_grad()
    def q_fn(o):
        x = torch.as_tensor(np.asarray(o, np.float32), device=dev)
        return model(x)[0].cpu().numpy()

    return q_fn
