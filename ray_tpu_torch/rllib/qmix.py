"""QMIX / VDN: value-decomposition multi-agent Q-learning (port of
ray_tpu/rllib/qmix.py).

Cooperative agents learn per-agent utilities Q_i(o_i, a_i), combined
into a team value Q_tot by a monotonic mixing network whose weights are
produced by hypernetworks of the global state (QMIX, Rashid et al. 2018:
non-negative mixing weights keep each agent's argmax consistent with the
joint one); VDN is the sum.  The global state is the concatenation of
the agents' observations.

The agents share one net, run as one batched forward over [B * agents]
rows.  A TD step: the agent Q of the taken actions mixed into Q_tot
against r + gamma * (1 - done) * the target mixer over the target agent
net's per-agent maxima, one plain Adam step (optax.adam: eps 1e-8, no
clip) over the agent net and the hypernetworks.  The targets are a copy
of the nets, taken at setup and at every `target_update_interval`-th
step; never an alias (the port updates in place, so an alias would
follow every step).  Weights are drawn on the CPU from a torch.Generator
seeded with the config's seed (w ~ N(0, 1) / sqrt(fan_in), b = 0, as
the reference draws them), exploration and replay from numpy's
default_rng(seed) in the reference's order; `convert.qmix_state_dict` /
`qmix_variables` carry the reference's param dict across.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.dqn import frozen_copy
from ray_tpu_torch.rllib.models import _Affine
from ray_tpu_torch.rllib.multi_agent import (MultiAgentVectorEnv,
                                             make_multi_agent_env,
                                             register_multi_agent_env)
from ray_tpu_torch.rllib.sac import plain_adam


class TwoStepGameEnv(MultiAgentVectorEnv):
    """The QMIX paper's two-step cooperative matrix game (Rashid et al.
    2018, section 5.1): agent a0's first action picks the second-step
    game — 2A pays 7 for every joint action; 2B pays [[0,1],[1,8]].
    The optimum (pick 2B, then both play 1 -> 8) needs the state-
    conditioned monotonic mixer; additive mixing may settle on the safe
    7."""

    agent_ids = ("a0", "a1")
    observation_dims = {"a0": 3, "a1": 3}   # one-hot state s0/s2A/s2B
    num_actions_by_agent = {"a0": 2, "a1": 2}
    PAYOFF_2B = np.array([[0.0, 1.0], [1.0, 8.0]])

    def __init__(self, num_envs: int, seed: int = 0):
        super().__init__(num_envs)
        self._state = np.zeros(num_envs, np.int64)   # 0=s0, 1=s2A, 2=s2B

    def _obs(self) -> Dict[str, np.ndarray]:
        onehot = np.eye(3, dtype=np.float32)[self._state]
        return {a: onehot.copy() for a in self.agent_ids}

    def reset_all(self, seed: Optional[int] = None):
        self._state[:] = 0
        for a in self.agent_ids:
            self._ep_return[a][:] = 0.0
        self._ep_len[:] = 0
        return self._obs()

    def step_batch(self, actions: Dict[str, np.ndarray]):
        a0 = np.asarray(actions["a0"])
        a1 = np.asarray(actions["a1"])
        in_s0 = self._state == 0
        team = np.zeros(self.num_envs, np.float32)
        # Step 2 payoffs:
        in_2a = self._state == 1
        in_2b = self._state == 2
        team[in_2a] = 7.0
        team[in_2b] = self.PAYOFF_2B[a0[in_2b], a1[in_2b]]
        terminated = ~in_s0
        # Step-1 transition: a0's action selects the matrix game.
        nxt = np.where(a0 == 0, 1, 2)
        self._state = np.where(in_s0, nxt, 0)   # done envs auto-reset
        rew = {a: team / 2.0 for a in self.agent_ids}  # team split
        return self._obs(), rew, terminated, np.zeros(self.num_envs, bool)


register_multi_agent_env("two-step-game", TwoStepGameEnv)


class QMixConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=QMix)
        self.env = "two-step-game"
        # One shared net across (homogeneous) agents: declare the map so
        # the Algorithm base probes the env as multi-agent.
        self.policies = ["shared"]
        self.policy_mapping_fn = _shared
        self.mixer = "qmix"              # "qmix" | "vdn"
        self.mixing_embed_dim = 16
        self.num_envs_per_worker = 16
        self.lr = 5e-3
        self.gamma = 0.99
        self.buffer_size = 4096
        self.train_batch_size = 128
        self.epsilon_timesteps = 2000    # linear 1.0 -> 0.05
        self.final_epsilon = 0.05
        self.target_update_interval = 100
        self.rollout_steps_per_iter = 64
        self.train_steps_per_iter = 16
        self.model_hidden = (64,)


def _shared(agent_id: str) -> str:
    return "shared"


class VDNConfig(QMixConfig):
    """VDN = additive mixing."""

    def __init__(self):
        super().__init__()
        self.mixer = "vdn"


class QMixNet(nn.Module):
    """The shared agent net (agent1, agent2) and, for QMIX, the
    hypernetworks (hyper_w1, hyper_b1, hyper_w2, hyper_b2_1,
    hyper_b2_2): each x @ w + b with w [in, out], named as the
    reference's param dict."""

    def __init__(self, obs_dim: int, n_agents: int, n_actions: int,
                 hidden: int, embed: int, mixer: str,
                 generator: torch.Generator):
        super().__init__()
        state_dim = obs_dim * n_agents

        def dense(n_in, n_out):
            return _Affine(n_in, n_out, 1.0 / math.sqrt(n_in), generator)

        self.agent1 = dense(obs_dim, hidden)
        self.agent2 = dense(hidden, n_actions)
        self.mixer = mixer
        self.n_agents, self.embed = n_agents, embed
        if mixer == "qmix":
            self.hyper_w1 = dense(state_dim, n_agents * embed)
            self.hyper_b1 = dense(state_dim, embed)
            self.hyper_w2 = dense(state_dim, embed)
            self.hyper_b2_1 = dense(state_dim, embed)
            self.hyper_b2_2 = dense(embed, 1)

    def agent_q(self, obs: torch.Tensor) -> torch.Tensor:
        """obs [B, n_agents, obs_dim] -> Q [B, n_agents, A], one forward
        over the B * n_agents rows."""
        rows = obs.reshape(-1, obs.shape[-1])
        q = self.agent2(torch.tanh(self.agent1(rows)))
        return q.reshape(*obs.shape[:-1], q.shape[-1])

    def mix(self, qs: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        """qs [B, n_agents] -> Q_tot [B]; monotone in every q_i."""
        if self.mixer == "vdn":
            return qs.sum(-1)
        w1 = torch.abs(self.hyper_w1(state)).reshape(
            -1, self.n_agents, self.embed)
        b1 = self.hyper_b1(state)
        hidden = F.elu(torch.bmm(qs[:, None, :], w1)[:, 0] + b1)
        w2 = torch.abs(self.hyper_w2(state))
        b2 = self.hyper_b2_2(F.relu(self.hyper_b2_1(state)))[:, 0]
        return (hidden * w2).sum(-1) + b2


class QMix(Algorithm):
    def setup(self) -> None:
        cfg = self.config
        self.device = resolve_device(cfg.device)
        self.env = make_multi_agent_env(cfg.env, cfg.num_envs_per_worker,
                                        seed=cfg.seed)
        self.agents: List[str] = list(self.env.agent_ids)
        self.n_agents = len(self.agents)
        # Homogeneous agents share one net: their spaces must match.
        dims = set(self.env.observation_dims.values())
        acts = set(self.env.num_actions_by_agent.values())
        if len(dims) != 1 or len(acts) != 1:
            raise ValueError("QMIX here shares one agent net: all agents "
                             "need identical obs/action spaces")
        self.agent_obs_dim = dims.pop()
        self.n_actions = acts.pop()
        self.state_dim = self.agent_obs_dim * self.n_agents
        self._rng = np.random.default_rng(cfg.seed)
        self.model = QMixNet(
            self.agent_obs_dim, self.n_agents, self.n_actions,
            cfg.model_hidden[0], cfg.mixing_embed_dim, cfg.mixer,
            torch.Generator().manual_seed(int(cfg.seed))).to(self.device)
        self.target = frozen_copy(self.model)
        self.opt = plain_adam(self.model.parameters(), cfg.lr)
        self._buf: List[Any] = []
        self._buf_pos = 0
        self._env_obs = self.env.reset_all(seed=cfg.seed)
        self._steps_sampled = 0
        self._train_steps = 0
        self.workers = None

    # -- learning ----------------------------------------------------------
    def td_loss(self, obs, actions, team_rew, next_obs, dones):
        """obs / next_obs [B, n_agents, obs_dim], actions [B, n_agents]
        (long), team_rew and dones [B]."""
        B = obs.shape[0]
        q_all = self.model.agent_q(obs)                       # [B, n, A]
        q_taken = q_all.gather(-1, actions[..., None])[..., 0]
        q_tot = self.model.mix(q_taken, obs.reshape(B, -1))
        # Decentralized-consistent target: per-agent max under the target
        # agent net, mixed by the target mixer.
        with torch.no_grad():
            tq_max = self.target.agent_q(next_obs).max(-1).values
            t_tot = self.target.mix(tq_max, next_obs.reshape(B, -1))
            y = team_rew + self.config.gamma * (1.0 - dones) * t_tot
        return ((q_tot - y) ** 2).mean()

    def train_step(self, o, a, r, no, d) -> torch.Tensor:
        """One TD step on numpy replay columns; returns the loss (a
        device scalar)."""
        dev = self.device
        loss = self.td_loss(
            torch.as_tensor(o, dtype=torch.float32, device=dev),
            torch.as_tensor(a, dtype=torch.long, device=dev),
            torch.as_tensor(r, dtype=torch.float32, device=dev),
            torch.as_tensor(no, dtype=torch.float32, device=dev),
            torch.as_tensor(d, dtype=torch.float32, device=dev))
        self.opt.step(torch.autograd.grad(loss, self.opt.params))
        return loss.detach()

    @torch.no_grad()
    def sync_target(self) -> None:
        for t, p in zip(self.target.parameters(), self.model.parameters()):
            t.copy_(p)

    # -- rollout / replay --------------------------------------------------
    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._steps_sampled / cfg.epsilon_timesteps)
        return 1.0 + frac * (cfg.final_epsilon - 1.0)

    @torch.no_grad()
    def _act(self, obs: Dict[str, np.ndarray], explore=True
             ) -> Dict[str, np.ndarray]:
        stacked = np.stack([obs[a] for a in self.agents], 1)  # [n_env,n,O]
        q = self.model.agent_q(torch.as_tensor(stacked, device=self.device))
        greedy = q.argmax(-1).cpu().numpy()                   # [n_env, n]
        if explore:
            eps = self._epsilon()
            rnd = self._rng.integers(0, self.n_actions, greedy.shape)
            mask = self._rng.random(greedy.shape) < eps
            greedy = np.where(mask, rnd, greedy)
        return {a: greedy[:, i] for i, a in enumerate(self.agents)}

    def _store(self, trans):
        if len(self._buf) < self.config.buffer_size:
            self._buf.append(trans)
        else:
            self._buf[self._buf_pos] = trans
            self._buf_pos = (self._buf_pos + 1) % self.config.buffer_size

    def sample_replay(self):
        """One minibatch of train_batch_size transitions drawn uniformly
        from the replay list: (obs, actions, team reward, next obs,
        done) as stacked numpy arrays."""
        idx = self._rng.integers(0, len(self._buf),
                                 self.config.train_batch_size)
        return tuple(np.stack(x) for x in zip(*[self._buf[i] for i in idx]))

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        for _ in range(cfg.rollout_steps_per_iter):
            obs = self._env_obs
            actions = self._act(obs)
            nobs, rew, term, trunc = self.env.step(actions)
            team = sum(np.asarray(rew[a], np.float32)
                       for a in self.agents)
            done = (term | trunc).astype(np.float32)
            o = np.stack([obs[a] for a in self.agents], 1)
            no = np.stack([nobs[a] for a in self.agents], 1)
            acts = np.stack([np.asarray(actions[a]) for a in self.agents],
                            1)
            for i in range(self.env.num_envs):
                self._store((o[i], acts[i], team[i], no[i], done[i]))
            self._env_obs = nobs
            self._steps_sampled += self.env.num_envs
        losses = []
        if len(self._buf) >= cfg.train_batch_size:
            for _ in range(cfg.train_steps_per_iter):
                losses.append(self.train_step(*self.sample_replay()))
                self._train_steps += 1
                if self._train_steps % cfg.target_update_interval == 0:
                    self.sync_target()
        rets, lens = self.env.drain_episode_metrics()
        # Team return = sum of the agents' per-episode returns.
        team_rets = [sum(vals) for vals in zip(*rets.values())]
        self._episode_returns.extend(team_rets)
        self._episode_lengths.extend(lens)
        self.total_env_steps += cfg.rollout_steps_per_iter * \
            self.env.num_envs
        td = (float(torch.stack(losses).mean().cpu()) if losses
              else np.nan)
        return {"episodes_this_iter": len(team_rets),
                "epsilon": self._epsilon(), "td_loss": td}

    def evaluate_greedy(self, episodes: int = 64) -> float:
        """Mean team return under the greedy decentralized policies."""
        env = make_multi_agent_env(self.config.env, episodes,
                                   seed=self.config.seed + 1)
        obs = env.reset_all()
        total = np.zeros(episodes, np.float64)
        # Episodes are masked, not restarted: each lane accumulates team
        # reward until its first done, then goes inactive, so auto-reset
        # lanes leak no second episode's reward into the mean.
        active = np.ones(episodes, bool)
        for _ in range(64):
            actions = self._act(obs, explore=False)
            obs, rew, term, trunc = env.step(actions)
            team_rew = sum(np.asarray(rew[a]) for a in self.agents)
            total += team_rew * active
            active &= ~(term | trunc)
            if not active.any():
                break
        return float(total.mean())

    def save_to_dict(self) -> Dict[str, Any]:
        """The reference's {"params", "target_params", "steps_sampled"}
        (numpy param dicts)."""
        return {"params": convert.qmix_variables(self.model),
                "target_params": convert.qmix_variables(self.target),
                "steps_sampled": self._steps_sampled}

    @torch.no_grad()
    def restore_from_dict(self, state: Dict[str, Any]) -> None:
        for net, key in ((self.model, "params"),
                         (self.target, "target_params")):
            net.load_state_dict(convert.qmix_state_dict(state[key], net))
        self._steps_sampled = state["steps_sampled"]
