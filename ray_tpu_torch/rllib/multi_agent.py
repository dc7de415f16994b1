"""Multi-agent RL: env contract, per-policy batches, rollout worker
(port of ray_tpu/rllib/multi_agent.py).

The env is natively vectorized per agent: one [B, ...] numpy step covers
all sub-envs for every agent, and the same seed gives the reference's
episodes.  Each policy's forward pass is one batched call of a
`TorchPolicy` on the worker's `device` (None -> CUDA).

Shared vs independent policies both ride the same path: the mapping
function routes each agent's rows to a policy id; a shared policy simply
receives every agent's rows concatenated.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.sample_batch import SampleBatch, compute_gae


class MultiAgentVectorEnv:
    """Vectorized multi-agent env with a FIXED agent set.

    Per-agent batched API (B = num sub-envs):
      reset_all(seed) -> {agent_id: [B, obs_dim]}
      step_batch({agent_id: [B]}) -> (obs_dict, reward_dict,
                                      terminated [B], truncated [B])
    Termination is per sub-env (all agents of one sub-env end together —
    the cooperative/competitive-game shape; reference MultiAgentEnv's
    "__all__" done flag).  Implementations auto-reset finished sub-envs.
    """

    agent_ids: Tuple[str, ...] = ()
    observation_dims: Dict[str, int] = {}
    num_actions_by_agent: Dict[str, int] = {}

    def __init__(self, num_envs: int):
        self.num_envs = num_envs
        self._ep_return = {a: np.zeros(num_envs, np.float64)
                           for a in self.agent_ids}
        self._ep_len = np.zeros(num_envs, np.int64)
        self.completed_returns: Dict[str, list] = {a: []
                                                   for a in self.agent_ids}
        self.completed_lengths: list = []

    def reset_all(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step_batch(self, actions: Dict[str, np.ndarray]):
        raise NotImplementedError

    def step(self, actions: Dict[str, np.ndarray]):
        obs, rew, term, trunc = self.step_batch(actions)
        for a in self.agent_ids:
            self._ep_return[a] += rew[a]
        self._ep_len += 1
        done = term | trunc
        if done.any():
            idx = np.nonzero(done)[0]
            for a in self.agent_ids:
                self.completed_returns[a].extend(
                    float(x) for x in self._ep_return[a][idx])
                self._ep_return[a][done] = 0.0
            self.completed_lengths.extend(
                int(x) for x in self._ep_len[idx])
            self._ep_len[done] = 0
        return obs, rew, term, trunc

    def drain_episode_metrics(self):
        rets = {a: self.completed_returns[a] for a in self.agent_ids}
        lens = self.completed_lengths
        self.completed_returns = {a: [] for a in self.agent_ids}
        self.completed_lengths = []
        return rets, lens


class CooperativeMatchEnv(MultiAgentVectorEnv):
    """Two-agent cooperative test env.

    Each agent observes its own one-hot target (4 classes) and earns 1.0
    for matching it; if BOTH match in the same step, both earn a +0.5
    cooperation bonus — so an agent's attainable return depends on its
    partner learning too.  Episodes run 16 steps with fresh targets each
    step: random policy ~ per-agent return 16*(0.25 + 0.5*0.0625) = 4.5;
    both-optimal = 16*1.5 = 24.
    """

    agent_ids = ("a0", "a1")
    N_TARGETS = 4
    EP_LEN = 16

    observation_dims = {"a0": 4, "a1": 4}
    num_actions_by_agent = {"a0": 4, "a1": 4}

    def __init__(self, num_envs: int, seed: int = 0):
        super().__init__(num_envs)
        self._rng = np.random.default_rng(seed)
        self._targets = {a: np.zeros(num_envs, np.int64)
                         for a in self.agent_ids}
        self._steps = np.zeros(num_envs, np.int64)

    def _roll_targets(self, mask=None):
        for a in self.agent_ids:
            fresh = self._rng.integers(0, self.N_TARGETS, self.num_envs)
            if mask is None:
                self._targets[a] = fresh
            else:
                self._targets[a] = np.where(mask, fresh, self._targets[a])

    def _obs(self) -> Dict[str, np.ndarray]:
        out = {}
        for a in self.agent_ids:
            o = np.zeros((self.num_envs, self.N_TARGETS), np.float32)
            o[np.arange(self.num_envs), self._targets[a]] = 1.0
            out[a] = o
        return out

    def reset_all(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._roll_targets()
        self._steps[:] = 0
        for a in self.agent_ids:
            self._ep_return[a][:] = 0.0
        self._ep_len[:] = 0
        return self._obs()

    def step_batch(self, actions: Dict[str, np.ndarray]):
        hit = {a: (np.asarray(actions[a]) == self._targets[a])
               for a in self.agent_ids}
        both = hit["a0"] & hit["a1"]
        rew = {a: hit[a].astype(np.float32) + 0.5 * both.astype(np.float32)
               for a in self.agent_ids}
        self._steps += 1
        truncated = self._steps >= self.EP_LEN
        terminated = np.zeros(self.num_envs, bool)
        self._roll_targets()          # fresh targets every step
        if truncated.any():
            self._steps[truncated] = 0
        return self._obs(), rew, terminated, truncated


_MA_REGISTRY: Dict[str, Callable[..., MultiAgentVectorEnv]] = {
    "coop-match": CooperativeMatchEnv,
}


def register_multi_agent_env(name: str, creator) -> None:
    _MA_REGISTRY[name] = creator


def make_multi_agent_env(name_or_creator, num_envs: int,
                         seed: int = 0) -> MultiAgentVectorEnv:
    if callable(name_or_creator):
        return name_or_creator(num_envs, seed)
    if name_or_creator in _MA_REGISTRY:
        return _MA_REGISTRY[name_or_creator](num_envs, seed=seed)
    raise ValueError(f"unknown multi-agent env {name_or_creator!r}")


class MultiAgentBatch:
    """{policy_id: SampleBatch} + env step count."""

    def __init__(self, policy_batches: Dict[str, SampleBatch],
                 env_steps: int):
        self.policy_batches = policy_batches
        self.count = env_steps

    @staticmethod
    def concat_samples(batches: List["MultiAgentBatch"]) -> "MultiAgentBatch":
        out: Dict[str, List[SampleBatch]] = {}
        steps = 0
        for mb in batches:
            steps += mb.count
            for pid, b in mb.policy_batches.items():
                out.setdefault(pid, []).append(b)
        return MultiAgentBatch(
            {pid: SampleBatch.concat_samples(bs) for pid, bs in out.items()},
            steps)


class MultiAgentRolloutWorker:
    """Steps a multi-agent vector env with one TorchPolicy per policy id,
    emitting a MultiAgentBatch per fragment."""

    def __init__(self, env: Any, *, num_envs: int = 8,
                 rollout_fragment_length: int = 64,
                 gamma: float = 0.99, lam: float = 0.95,
                 hidden=(64, 64), seed: int = 0,
                 policies: Optional[Dict[str, Any]] = None,
                 policy_mapping_fn: Optional[Callable[[str], str]] = None,
                 device: DeviceLike = None):
        self.env = make_multi_agent_env(env, num_envs, seed=seed)
        self.num_envs = num_envs
        self.fragment_length = rollout_fragment_length
        self.gamma, self.lam = gamma, lam
        self.agent_ids = self.env.agent_ids
        self.policy_mapping_fn = policy_mapping_fn or (lambda aid: aid)
        pids = sorted({self.policy_mapping_fn(a) for a in self.agent_ids})
        if policies:
            unknown = set(pids) - set(policies)
            if unknown:
                raise ValueError(
                    f"policy_mapping_fn routes to undeclared policies "
                    f"{sorted(unknown)}; declared: {sorted(policies)}")
        self.policies: Dict[str, TorchPolicy] = {}
        for pid in pids:
            # Every agent mapped to `pid` must share obs/action spaces.
            agents = [a for a in self.agent_ids
                      if self.policy_mapping_fn(a) == pid]
            dims = {self.env.observation_dims[a] for a in agents}
            acts = {self.env.num_actions_by_agent[a] for a in agents}
            if len(dims) != 1 or len(acts) != 1:
                raise ValueError(
                    f"agents {agents} share policy {pid!r} but have "
                    f"mismatched spaces")
            self.policies[pid] = TorchPolicy(
                dims.pop(), acts.pop(), hidden,
                seed=seed + 17 * (1 + pids.index(pid)), device=device)
        self.obs = self.env.reset_all(seed)
        self._total_steps = 0

    # -- weights -----------------------------------------------------------
    def get_weights(self) -> Dict[str, Any]:
        return {pid: p.get_weights() for pid, p in self.policies.items()}

    def set_weights(self, weights: Dict[str, Any]) -> None:
        for pid, w in weights.items():
            if pid in self.policies:
                self.policies[pid].set_weights(w)

    # -- sampling ----------------------------------------------------------
    def sample(self) -> Tuple[MultiAgentBatch, Dict]:
        T, B = self.fragment_length, self.num_envs
        A = self.agent_ids
        obs_buf = {a: np.empty((T, B, self.env.observation_dims[a]),
                               np.float32) for a in A}
        act_buf = {a: np.empty((T, B), np.int32) for a in A}
        logp_buf = {a: np.empty((T, B), np.float32) for a in A}
        vf_buf = {a: np.empty((T, B), np.float32) for a in A}
        rew_buf = {a: np.empty((T, B), np.float32) for a in A}
        term_buf = np.empty((T, B), np.bool_)
        trunc_buf = np.empty((T, B), np.bool_)

        obs = self.obs
        for t in range(T):
            actions = {}
            for a in A:
                pol = self.policies[self.policy_mapping_fn(a)]
                acts, logp, vf, _ = pol.compute_actions(obs[a])
                actions[a] = acts
                obs_buf[a][t] = obs[a]
                act_buf[a][t] = acts
                logp_buf[a][t] = logp
                vf_buf[a][t] = vf
            obs, rew, term, trunc = self.env.step(actions)
            for a in A:
                rew_buf[a][t] = rew[a]
            term_buf[t] = term
            trunc_buf[t] = trunc
        self.obs = obs
        self._total_steps += T * B

        rets, lens = self.env.drain_episode_metrics()
        # Per-policy mean returns for the improvement gates; the scalar
        # episode metric folds all agents (cooperative sum / len(A)).
        per_agent = {a: rets[a] for a in A}
        pooled = [r for a in A for r in rets[a]]
        metrics = {"episode_returns": pooled, "episode_lengths": lens,
                   "per_agent_returns": per_agent,
                   "env_steps": T * B, "total_env_steps": self._total_steps}

        done = term_buf | trunc_buf
        flat = lambda x: x.reshape((T * B,) + x.shape[2:])
        per_policy: Dict[str, List[SampleBatch]] = {}
        for a in A:
            pol = self.policies[self.policy_mapping_fn(a)]
            _, _, boot_vf, _ = pol.compute_actions(self.obs[a])
            adv, targets = compute_gae(rew_buf[a], vf_buf[a], done,
                                       boot_vf, self.gamma, self.lam)
            b = SampleBatch({
                SampleBatch.OBS: flat(obs_buf[a]),
                SampleBatch.ACTIONS: flat(act_buf[a]),
                SampleBatch.ACTION_LOGP: flat(logp_buf[a]),
                SampleBatch.VF_PREDS: flat(vf_buf[a]),
                SampleBatch.ADVANTAGES: flat(adv),
                SampleBatch.VALUE_TARGETS: flat(targets),
            })
            per_policy.setdefault(self.policy_mapping_fn(a), []).append(b)
        batch = MultiAgentBatch(
            {pid: SampleBatch.concat_samples(bs)
             for pid, bs in per_policy.items()}, T * B)
        return batch, metrics

    def ping(self) -> bool:
        return True
