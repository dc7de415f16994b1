"""RolloutWorker: experience collection (port of
ray_tpu/rllib/rollout_worker.py, feed-forward actor-critic policies).

The env is natively vectorized (one numpy step for all sub-envs), the
policy forward is one call per timestep over the whole env batch, and
postprocessing (GAE) is vectorized over the fragment.  The policy runs
on `device` (None -> CUDA): the reference pins rollout policies to the
host CPU; here the caller places them (the algorithms forward their
config's `rollout_device`).

Waiting for the algorithms that need them (ROADMAP A9): recurrent
policies (`_sample_recurrent`), continuous actions, and the value-based
knobs (`epsilon_schedule`, `exploration`, `obs_connector`,
`action_connector`, policy kinds other than "actor_critic").
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.rllib.env import make_vector_env
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.sample_batch import SampleBatch, compute_gae

_WAITS = "waits for the {} of ROADMAP A9"


class RolloutWorker:
    """Steps a vectorized env with the current policy and emits
    SampleBatches.  Runs as an actor of the caller's runtime, or directly
    in-process (the local-worker mode the reference uses for
    num_workers=0)."""

    def __init__(self, env: Any, *, num_envs: int = 8,
                 rollout_fragment_length: int = 64,
                 gamma: float = 0.99, lam: float = 0.95,
                 hidden=(64, 64), seed: int = 0,
                 postprocess: bool = True,
                 policy_kind: str = "actor_critic",
                 epsilon_schedule=None, exploration=None,
                 obs_connector=None, action_connector=None,
                 device: DeviceLike = None):
        if policy_kind != "actor_critic":
            raise NotImplementedError(
                f"policy_kind={policy_kind!r} " + _WAITS.format(
                    "recurrent and value-based algorithms"))
        knobs = dict(epsilon_schedule=epsilon_schedule,
                     exploration=exploration, obs_connector=obs_connector,
                     action_connector=action_connector)
        for name, value in knobs.items():
            if value is not None:
                raise NotImplementedError(
                    f"{name} " + _WAITS.format("value-based algorithms"))
        self.env = make_vector_env(env, num_envs, seed=seed)
        self.num_envs = num_envs
        self.fragment_length = rollout_fragment_length
        self.gamma, self.lam = gamma, lam
        self.postprocess = postprocess
        if getattr(self.env, "num_actions", 0) == 0:
            raise NotImplementedError(
                f"env {env!r} has continuous actions, which " + _WAITS.format(
                    "continuous-action item (GaussianActorCritic)"))
        self.policy = TorchPolicy(self.env.observation_dim,
                                  self.env.num_actions, hidden, seed=seed,
                                  device=device)
        self.obs = self.env.reset_all(seed)
        self._total_steps = 0

    # -- weights -----------------------------------------------------------
    def get_weights(self):
        return self.policy.get_weights()

    def set_weights(self, weights) -> None:
        self.policy.set_weights(weights)

    # -- sampling ----------------------------------------------------------
    def sample(self) -> Tuple[SampleBatch, Dict]:
        """Collect one fragment: [T, B] steps, T=fragment_length,
        B=num_envs.

        Returns (batch, metrics).  With postprocess=True the batch is
        flattened to [T*B] rows with GAE advantages/value targets (PPO
        path); otherwise it stays time-major [T, B, ...] with behavior
        logits and `bootstrap_obs` [B, ...] (IMPALA/V-trace path).
        """
        T, B = self.fragment_length, self.num_envs
        obs_buf = np.empty((T, B) + self.obs.shape[1:], self.obs.dtype)
        act_buf = np.empty((T, B), np.int32)
        logits_buf = np.empty((T, B, self.env.num_actions), np.float32)
        rew_buf = np.empty((T, B), np.float32)
        term_buf = np.empty((T, B), np.bool_)
        trunc_buf = np.empty((T, B), np.bool_)
        logp_buf = np.empty((T, B), np.float32)
        vf_buf = np.empty((T, B), np.float32)

        obs = self.obs
        for t in range(T):
            actions, logp, vf, logits = self.policy.compute_actions(obs)
            obs_buf[t] = obs
            act_buf[t] = actions
            logp_buf[t] = logp
            vf_buf[t] = vf
            logits_buf[t] = logits
            obs, rew, term, trunc = self.env.step(actions)
            rew_buf[t] = rew
            term_buf[t] = term
            trunc_buf[t] = trunc
        self.obs = obs
        self._total_steps += T * B

        rets, lens = self.env.drain_episode_metrics()
        metrics = {"episode_returns": rets, "episode_lengths": lens,
                   "env_steps": T * B, "total_env_steps": self._total_steps}

        if not self.postprocess:
            batch = SampleBatch({
                SampleBatch.OBS: obs_buf, SampleBatch.ACTIONS: act_buf,
                SampleBatch.REWARDS: rew_buf,
                SampleBatch.TERMINATEDS: term_buf,
                SampleBatch.TRUNCATEDS: trunc_buf,
                SampleBatch.ACTION_LOGP: logp_buf,
                SampleBatch.ACTION_LOGITS: logits_buf,
                "bootstrap_obs": self.obs,
            })
            return batch, metrics

        # GAE.  Episodes end at terminated|truncated (auto-reset envs), as
        # in the reference.
        done = term_buf | trunc_buf
        _, _, bootstrap_vf, _ = self.policy.compute_actions(self.obs)
        adv, targets = compute_gae(rew_buf, vf_buf, done, bootstrap_vf,
                                   self.gamma, self.lam)

        def flat(x):
            return x.reshape((T * B,) + x.shape[2:])

        batch = SampleBatch({
            SampleBatch.OBS: flat(obs_buf),
            SampleBatch.ACTIONS: flat(act_buf),
            SampleBatch.ACTION_LOGP: flat(logp_buf),
            SampleBatch.VF_PREDS: flat(vf_buf),
            SampleBatch.ADVANTAGES: flat(adv),
            SampleBatch.VALUE_TARGETS: flat(targets),
        })
        return batch, metrics

    def evaluate(self, num_episodes: int = 10,
                 max_steps: int = 1000) -> Dict:
        """Greedy-policy evaluation rollouts."""
        self.env.drain_episode_metrics()
        returns: list = []
        obs = self.obs
        steps = 0
        while len(returns) < num_episodes and steps < max_steps:
            actions, _, _, _ = self.policy.compute_actions(obs, explore=False)
            obs, _, _, _ = self.env.step(actions)
            steps += 1
            rets, _ = self.env.drain_episode_metrics()
            returns.extend(rets)
        self.obs = obs
        return {"episode_returns": returns}

    def ping(self) -> bool:
        return True
