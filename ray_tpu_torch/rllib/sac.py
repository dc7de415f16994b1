"""SAC: soft actor-critic for continuous control (port of
ray_tpu/rllib/sac.py).

One update, in the reference's order:
1. the critic step: the soft TD target r + gamma * (1 - terminated) *
   (min(Q1', Q2')(s', a') - alpha * logp(a' | s')) from the target twins,
   a' a squashed sample of the pre-step actor, alpha = exp(log_alpha)
   before this update; one Adam over q1 and q2 together;
2. the actor step against the *updated* q1 and q2 and the pre-step
   alpha: mean(alpha * logp - min(Q1, Q2)) of a reparameterized sample;
3. the temperature step on log_alpha: -mean(log_alpha * (logp +
   target_entropy)), logp held fixed;
4. polyak: target = (1 - tau) * target + tau * online, for q1 and q2.

Each optimizer is plain optax.adam (eps 1e-8, no clip): `ClipAdam` with
max_norm None.  The reference splits its key three ways a step and draws
N(0, 1) for the next-state and the policy samples; the port draws both
from its own generator, or takes them from the caller (`update(batch,
noise=(next_noise, pi_noise))`), which is how the tests hand both
packages the same draws.  The targets are copies, never aliases: the
port updates in place, so only the polyak step moves them.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.dqn import (OffPolicyAlgorithm, frozen_copy,
                                     metrics_to_host)
from ray_tpu_torch.rllib.learner import ClipAdam, batch_tensors
from ray_tpu_torch.rllib.models import make_offpolicy_model
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.worker_set import WorkerSet


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=SAC)
        self.actor_lr = 3e-4
        self.critic_lr = 3e-4
        self.alpha_lr = 3e-4
        self.tau = 0.005                   # polyak coefficient
        self.initial_alpha = 1.0
        self.target_entropy = None         # default: -action_dim
        self.replay_buffer_capacity = 100_000
        self.learning_starts = 1_500
        self.random_warmup_steps = 1_000   # uniform actions at the start
        self.train_batch_size = 256
        self.updates_per_step = 32
        self.model_hidden = (256, 256)


def env_scale(action_low, action_high):
    """(scale, center) of the env's bounds, as the reference computes
    them (numpy, then float32)."""
    low, high = np.asarray(action_low), np.asarray(action_high)
    return (float(np.float32((high - low) / 2.0)),
            float(np.float32((high + low) / 2.0)))


@torch.no_grad()
def polyak_(targets: Sequence[torch.Tensor], sources: Sequence[torch.Tensor],
            tau: float) -> None:
    """targets = (1 - tau) * targets + tau * sources, in place, rounded as
    the reference's expression (two products, one sum; `lerp` rounds
    otherwise)."""
    torch._foreach_mul_(targets, 1.0 - tau)
    torch._foreach_add_(targets, torch._foreach_mul(sources, tau))


def plain_adam(params, lr: float) -> ClipAdam:
    """optax.adam(lr): eps 1e-8, no clip."""
    return ClipAdam(params, lr, None, eps=1e-8)


def adam_opt_tree(opt: ClipAdam, models) -> tuple:
    """optax.adam's state (ScaleByAdamState, EmptyState()) of `opt`,
    whose params are those of `models` (one model, a tuple, or None for a
    scalar), as the reference's tree of numpy arrays."""
    if models is None:
        def tree(moments):
            return moments[0].detach().cpu().numpy().copy()
    else:
        def tree(moments):
            return convert.moments_tree(moments, models)
    return (convert.adam_state_tree(opt.count, opt.mu, opt.nu, tree),
            convert.EmptyState())


def load_adam(opt: ClipAdam, state, models) -> None:
    """Load optax.adam's state (either package's) into `opt`."""
    if models is None:
        def moments(leaf):
            return [torch.as_tensor(np.asarray(leaf), dtype=torch.float32)]
    else:
        def moments(tree):
            return convert.model_moments(tree, models)
    count, mu, nu = convert.adam_state(state[0], moments)
    opt.count = count
    for dst, src in zip(opt.mu + opt.nu, mu + nu):
        dst.copy_(src)


def _noise(noise, shape, gen, device):
    if noise is None:
        return torch.randn(shape, generator=gen, device=device)
    return torch.as_tensor(np.asarray(noise), dtype=torch.float32,
                           device=device)


def squashed_sample(actor, obs, noise, scale: float, center: float):
    """Reparameterized tanh-Gaussian sample in env scale and its
    log-prob: logp of u = mean + std * noise under N(mean, std), minus
    sum(log(scale * (1 - tanh(u)^2) + 1e-6)), the 1e-6 inside the log
    and after the scale."""
    mean, log_std = actor(obs)
    u = mean + torch.exp(log_std) * noise
    logp_u = torch.sum(-0.5 * ((u - mean) ** 2) * torch.exp(-2 * log_std)
                       - log_std - 0.5 * math.log(2 * math.pi), dim=-1)
    t = torch.tanh(u)
    log_det = torch.sum(torch.log(scale * (1 - t ** 2) + 1e-6), dim=-1)
    return t * scale + center, logp_u - log_det


class _SACLearner:
    """Twin soft Q, a squashed-Gaussian actor and an autotuned
    temperature; `device=None` means CUDA."""

    def __init__(self, obs_dim: int, action_dim: int, cfg: SACConfig,
                 action_low, action_high, seed: int,
                 device: DeviceLike = None):
        self.device = dev = resolve_device(device)
        hidden = cfg.model_hidden
        self.actor = make_offpolicy_model("squashed", obs_dim, action_dim,
                                          hidden, seed=seed, device=dev)
        self.q1 = make_offpolicy_model("q", obs_dim, action_dim, hidden,
                                       seed=seed + 1, device=dev)
        self.q2 = make_offpolicy_model("q", obs_dim, action_dim, hidden,
                                       seed=seed + 2, device=dev)
        self.q1_t, self.q2_t = frozen_copy(self.q1), frozen_copy(self.q2)
        self.log_alpha = torch.tensor(float(np.log(cfg.initial_alpha)),
                                      dtype=torch.float32, device=dev,
                                      requires_grad=True)
        self.actor_opt = plain_adam(self.actor.parameters(), cfg.actor_lr)
        self.critic_opt = plain_adam(
            [*self.q1.parameters(), *self.q2.parameters()], cfg.critic_lr)
        self.alpha_opt = plain_adam([self.log_alpha], cfg.alpha_lr)
        self.scale, self.center = env_scale(action_low, action_high)
        self.action_dim = action_dim
        self.target_entropy = (cfg.target_entropy
                               if cfg.target_entropy is not None
                               else -float(action_dim))
        self.gamma, self.tau = cfg.gamma, cfg.tau
        self.num_updates = 0
        self._gen = torch.Generator(dev).manual_seed(seed + 7)
        self._lock = threading.Lock()

    def update(self, batch, noise: Optional[tuple] = None
               ) -> Dict[str, float]:
        """One SAC step; `noise` = (next_noise, pi_noise), each
        [batch, action_dim] standard normals, or None to draw them."""
        b = batch_tensors(batch, self.device)
        obs, next_obs, actions = b["obs"], b["next_obs"], b["actions"]
        shape = (len(obs), self.action_dim)
        next_noise, pi_noise = noise if noise is not None else (None, None)
        next_noise = _noise(next_noise, shape, self._gen, self.device)
        pi_noise = _noise(pi_noise, shape, self._gen, self.device)
        alpha = self.log_alpha.detach().exp()

        # 1. critic: soft TD target from the target twins.
        with torch.no_grad():
            next_a, next_logp = squashed_sample(
                self.actor, next_obs, next_noise, self.scale, self.center)
            q_next = torch.minimum(self.q1_t(next_obs, next_a),
                                   self.q2_t(next_obs, next_a))
            target = b["rewards"] + self.gamma * (
                1.0 - b["dones"].float()) * (q_next - alpha * next_logp)
        e1 = self.q1(obs, actions) - target
        e2 = self.q2(obs, actions) - target
        c_loss = (e1 ** 2 + e2 ** 2).mean()
        c_grads = torch.autograd.grad(c_loss, self.critic_opt.params)
        with self._lock:
            self.critic_opt.step(c_grads)

        # 2. actor: against the updated twins and the pre-step alpha.
        a_pi, logp_pi = squashed_sample(self.actor, obs, pi_noise,
                                        self.scale, self.center)
        q_pi = torch.minimum(self.q1(obs, a_pi), self.q2(obs, a_pi))
        a_loss = (alpha * logp_pi - q_pi).mean()
        a_grads = torch.autograd.grad(a_loss, self.actor_opt.params)

        # 3. temperature: drive the policy's entropy toward the target.
        al_loss = -(self.log_alpha
                    * (logp_pi.detach() + self.target_entropy)).mean()
        al_grads = torch.autograd.grad(al_loss, [self.log_alpha])
        with self._lock:
            self.actor_opt.step(a_grads)
            self.alpha_opt.step(al_grads)
            # 4. polyak targets.
            polyak_(list(self.q1_t.parameters())
                    + list(self.q2_t.parameters()),
                    self.critic_opt.params, self.tau)
            self.num_updates += 1
        return metrics_to_host({
            "critic_loss": c_loss, "actor_loss": a_loss,
            "alpha_loss": al_loss, "alpha": self.log_alpha.detach().exp(),
            "entropy": -logp_pi.detach().mean()})

    def get_weights(self):
        with self._lock:
            return convert.actor_critic_variables(self.actor)

    def get_state(self):
        """The reference's {"sac_state": {...}, "num_updates"}, numpy,
        "rng" None (each package keeps its own draws)."""
        v = convert.actor_critic_variables
        with self._lock:
            s = {"actor": v(self.actor), "q1": v(self.q1), "q2": v(self.q2),
                 "q1_t": v(self.q1_t), "q2_t": v(self.q2_t),
                 "log_alpha": self.log_alpha.detach().cpu().numpy().copy(),
                 "actor_opt": adam_opt_tree(self.actor_opt, self.actor),
                 "critic_opt": adam_opt_tree(self.critic_opt,
                                             (self.q1, self.q2)),
                 "alpha_opt": adam_opt_tree(self.alpha_opt, None),
                 "rng": None}
        return {"sac_state": s, "num_updates": self.num_updates}

    @torch.no_grad()
    def set_state(self, state):
        s = state["sac_state"]
        with self._lock:
            for name in ("actor", "q1", "q2", "q1_t", "q2_t"):
                model = getattr(self, name)
                model.load_state_dict(
                    convert.actor_critic_state_dict(s[name], model))
            self.log_alpha.copy_(torch.as_tensor(np.asarray(s["log_alpha"])))
            load_adam(self.actor_opt, s["actor_opt"], self.actor)
            load_adam(self.critic_opt, s["critic_opt"], (self.q1, self.q2))
            load_adam(self.alpha_opt, s["alpha_opt"], None)
            self.num_updates = int(state.get("num_updates", 0))


class SAC(OffPolicyAlgorithm):
    def setup(self) -> None:
        cfg = self.config
        if not self.continuous:
            raise ValueError("SAC requires a continuous-action env")
        self.workers = WorkerSet(
            num_workers=cfg.num_rollout_workers, runtime=cfg.runtime,
            num_cpus_per_worker=cfg.num_cpus_per_worker,
            worker_kwargs=self.worker_kwargs(
                postprocess=False, policy_kind="squashed_gaussian",
                random_warmup_steps=cfg.random_warmup_steps))
        probe = self.workers.local_worker.env
        self.learner = _SACLearner(
            self.obs_dim, self.action_dim, cfg, probe.action_low,
            probe.action_high, cfg.seed, device=cfg.device)
        self.buffer = ReplayBuffer(cfg.replay_buffer_capacity,
                                   seed=cfg.seed)
        self.workers.sync_weights(self.learner.get_weights())
