"""TD3: twin-delayed deep deterministic policy gradient (port of
ray_tpu/rllib/td3.py).

Every update takes the critic step: the target r + gamma * (1 -
terminated) * min(Q1', Q2')(s', a'), a' = clip(actor'(s') * scale +
center + clip(target_noise * scale * N(0, 1), +-target_noise_clip *
scale), bounds) from the target actor, one Adam over q1 and q2 together.
Every `policy_delay`-th update also takes the actor step
(-mean(Q1(s, actor(s))) against the updated q1), and that step alone
moves the polyak targets of the actor, q1 and q2.  Optimizers are plain
optax.adam.  The smoothing noise comes from the port's generator, or
from the caller (`update(batch, noise=...)`, [batch, action_dim]
standard normals).  The targets are copies, never aliases.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.dqn import (OffPolicyAlgorithm, frozen_copy,
                                     metrics_to_host)
from ray_tpu_torch.rllib.learner import batch_tensors
from ray_tpu_torch.rllib.models import make_offpolicy_model
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.policy import action_bounds
from ray_tpu_torch.rllib.sac import (_noise, adam_opt_tree, load_adam,
                                     plain_adam, polyak_)
from ray_tpu_torch.rllib.worker_set import WorkerSet


class TD3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=TD3)
        self.actor_lr = 1e-3
        self.critic_lr = 1e-3
        self.tau = 0.005
        self.policy_delay = 2              # critic updates per actor update
        self.target_noise = 0.2            # smoothing noise sigma (x scale)
        self.target_noise_clip = 0.5       # clip (x scale)
        self.exploration_noise = 0.1       # rollout noise sigma (x scale)
        self.replay_buffer_capacity = 100_000
        self.learning_starts = 1_500
        self.random_warmup_steps = 1_000
        self.train_batch_size = 256
        self.updates_per_step = 32
        self.model_hidden = (256, 256)


class _TD3Learner:
    """Twin Q, a delayed deterministic actor and target smoothing;
    `device=None` means CUDA."""

    def __init__(self, obs_dim: int, action_dim: int, cfg: TD3Config,
                 action_low, action_high, seed: int,
                 device: DeviceLike = None):
        self.device = dev = resolve_device(device)
        hidden = cfg.model_hidden
        self.actor = make_offpolicy_model("deterministic", obs_dim,
                                          action_dim, hidden, seed=seed,
                                          device=dev)
        self.q1 = make_offpolicy_model("q", obs_dim, action_dim, hidden,
                                       seed=seed + 1, device=dev)
        self.q2 = make_offpolicy_model("q", obs_dim, action_dim, hidden,
                                       seed=seed + 2, device=dev)
        self.actor_t = frozen_copy(self.actor)
        self.q1_t, self.q2_t = frozen_copy(self.q1), frozen_copy(self.q2)
        self.actor_opt = plain_adam(self.actor.parameters(), cfg.actor_lr)
        self.critic_opt = plain_adam(
            [*self.q1.parameters(), *self.q2.parameters()], cfg.critic_lr)
        self.low, self.high, self.scale, self.center = action_bounds(
            action_low, action_high, dev)
        self.action_dim = action_dim
        self.gamma, self.tau = cfg.gamma, cfg.tau
        self.noise_sigma = cfg.target_noise
        self.noise_clip = cfg.target_noise_clip
        self.policy_delay = cfg.policy_delay
        self.num_updates = 0
        self._gen = torch.Generator(dev).manual_seed(seed + 7)
        self._lock = threading.Lock()

    def _act(self, actor, obs):
        return actor(obs) * self.scale + self.center

    def update(self, batch, noise: Optional[object] = None
               ) -> Dict[str, float]:
        """The critic step, then on every policy_delay-th update the actor
        step and the polyak targets.  `noise`: [batch, action_dim]
        standard normals for the target smoothing, or None to draw."""
        b = batch_tensors(batch, self.device)
        obs, next_obs = b["obs"], b["next_obs"]
        eps = _noise(noise, (len(obs), self.action_dim), self._gen,
                     self.device)
        with torch.no_grad():
            a_next = self._act(self.actor_t, next_obs)
            lim = self.noise_clip * self.scale
            smooth = torch.clamp(self.noise_sigma * self.scale * eps,
                                 -lim, lim)
            a_next = torch.clamp(a_next + smooth, self.low, self.high)
            q_next = torch.minimum(self.q1_t(next_obs, a_next),
                                   self.q2_t(next_obs, a_next))
            target = b["rewards"] + self.gamma * (
                1.0 - b["dones"].float()) * q_next
        e1 = self.q1(obs, b["actions"]) - target
        e2 = self.q2(obs, b["actions"]) - target
        c_loss = (e1 ** 2 + e2 ** 2).mean()
        c_grads = torch.autograd.grad(c_loss, self.critic_opt.params)
        with self._lock:
            self.critic_opt.step(c_grads)
            self.num_updates += 1
        metrics = {"critic_loss": c_loss}
        if self.num_updates % self.policy_delay == 0:
            a_loss = -self.q1(obs, self._act(self.actor, obs)).mean()
            a_grads = torch.autograd.grad(a_loss, self.actor_opt.params)
            with self._lock:
                self.actor_opt.step(a_grads)
                polyak_([*self.actor_t.parameters(),
                         *self.q1_t.parameters(), *self.q2_t.parameters()],
                        [*self.actor_opt.params, *self.critic_opt.params],
                        self.tau)
            metrics["actor_loss"] = a_loss
        return metrics_to_host(metrics)

    def get_weights(self):
        with self._lock:
            return convert.actor_critic_variables(self.actor)

    def get_state(self):
        """The reference's {"td3_state": {...}, "num_updates"}, numpy,
        "rng" None."""
        v = convert.actor_critic_variables
        with self._lock:
            s = {"actor": v(self.actor), "actor_t": v(self.actor_t),
                 "q1": v(self.q1), "q2": v(self.q2), "q1_t": v(self.q1_t),
                 "q2_t": v(self.q2_t),
                 "actor_opt": adam_opt_tree(self.actor_opt, self.actor),
                 "critic_opt": adam_opt_tree(self.critic_opt,
                                             (self.q1, self.q2)),
                 "rng": None}
        return {"td3_state": s, "num_updates": self.num_updates}

    @torch.no_grad()
    def set_state(self, state):
        s = state["td3_state"]
        with self._lock:
            for name in ("actor", "actor_t", "q1", "q2", "q1_t", "q2_t"):
                model = getattr(self, name)
                model.load_state_dict(
                    convert.actor_critic_state_dict(s[name], model))
            load_adam(self.actor_opt, s["actor_opt"], self.actor)
            load_adam(self.critic_opt, s["critic_opt"], (self.q1, self.q2))
            self.num_updates = int(state.get("num_updates", 0))


class TD3(OffPolicyAlgorithm):
    def setup(self) -> None:
        cfg = self.config
        if not self.continuous:
            raise ValueError("TD3 requires a continuous-action env")
        self.workers = WorkerSet(
            num_workers=cfg.num_rollout_workers, runtime=cfg.runtime,
            num_cpus_per_worker=cfg.num_cpus_per_worker,
            worker_kwargs=self.worker_kwargs(
                postprocess=False, policy_kind="deterministic_noise",
                exploration_noise=cfg.exploration_noise,
                random_warmup_steps=cfg.random_warmup_steps))
        probe = self.workers.local_worker.env
        self.learner = _TD3Learner(
            self.obs_dim, self.action_dim, cfg, probe.action_low,
            probe.action_high, cfg.seed, device=cfg.device)
        self.buffer = ReplayBuffer(cfg.replay_buffer_capacity,
                                   seed=cfg.seed)
        self.workers.sync_weights(self.learner.get_weights())
