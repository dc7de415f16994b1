"""Evolution Strategies (OpenAI-ES, Salimans et al. 2017; port of
ray_tpu/rllib/es.py).

Workers regenerate each perturbation from its integer seed
(`default_rng(seed).standard_normal(dim)` in f32, the reference's noise),
so only seeds cross the wire.  A worker evaluates its whole population
slice at once: lanes 2i / 2i+1 run theta +/- sigma * eps_i, and one env
step is one population forward on the device, a `torch.baddbmm` per
layer over the [B, dim] parameter matrix sliced into W [B, n_in, n_out]
and b [B, n_out] views, with tanh between layers.  The greedy argmax
(discrete) or tanh (continuous) runs on the device too; only the [B]
actions come back to the host.  Episodes are masked at each lane's
first done, as in the reference.

The flat parameter layout is the reference's (per layer: W row-major
[n_in, n_out], then b), so a theta crosses both packages as it is.  The
algorithm's update (centered ranks, the gradient, Adam on the flat
vector) is the reference's numpy code, dtypes included: theta stays f32
and is updated in place; the Adam moments start f32 and turn f64 at the
first step, because the gradient is f64.

The runtime reaches the port only as a handle
(`ESConfig().resources(runtime=ray_tpu)`: `remote`, `get`, `kill`); the
workers' forward runs on `.resources(device=...)` (None -> CUDA).  The
evaluation worker is shared with ARS (ars.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import make_vector_env, shippable_env

# Seconds `_fan_out` allows one round of evaluations.
EVAL_TIMEOUT_S = 600


# ---------------------------------------------------------------------------
# Flat-vector MLP policy (the ES/ARS search space).
# ---------------------------------------------------------------------------

def _mlp_shapes(obs_dim: int, hidden: Tuple[int, ...], out_dim: int):
    dims = (obs_dim,) + tuple(hidden) + (out_dim,)
    return [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]


def _init_flat(obs_dim: int, hidden: Tuple[int, ...], out_dim: int,
               seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    parts = []
    for n_in, n_out in _mlp_shapes(obs_dim, hidden, out_dim):
        parts.append((rng.standard_normal((n_in, n_out))
                      / np.sqrt(n_in)).astype(np.float32).ravel())
        parts.append(np.zeros(n_out, np.float32))
    return np.concatenate(parts)


def _noise(seed: int, dim: int) -> np.ndarray:
    return np.random.default_rng(int(seed)).standard_normal(dim).astype(
        np.float32)


def population_layers(pop: torch.Tensor, shapes) -> list:
    """[(W [B, n_in, n_out], b [B, 1, n_out])] views of the [B, dim]
    parameter matrix, in the flat layout of `_init_flat`."""
    lanes, off, layers = pop.shape[0], 0, []
    for n_in, n_out in shapes:
        w = pop[:, off:off + n_in * n_out].view(lanes, n_in, n_out)
        off += n_in * n_out
        b = pop[:, off:off + n_out].view(lanes, 1, n_out)
        off += n_out
        layers.append((w, b))
    return layers


def population_forward(layers: list, x: torch.Tensor) -> torch.Tensor:
    """Lane i runs the MLP with its own parameters on x[i]: [B, n_in] ->
    [B, out], one batched product per layer (the reference's
    jit(vmap(apply_one)))."""
    h = x.unsqueeze(1)
    for i, (w, b) in enumerate(layers):
        h = torch.baddbmm(b, h, w)
        if i < len(layers) - 1:
            h = torch.tanh(h)
    return h.squeeze(1)


# ---------------------------------------------------------------------------


class EvalWorker:
    """Evaluates perturbed parameter vectors for full (masked) episodes.

    Bound to a runtime as `runtime.remote(num_cpus=...)(EvalWorker)`.
    One call evaluates the whole assigned population slice (antithetic
    pairs: lanes 2i / 2i+1 run theta +/- sigma*eps_i)."""

    def __init__(self, env: Any, hidden: Tuple[int, ...], seed: int,
                 horizon: int = 500, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._env_spec = env
        self._hidden = tuple(hidden)
        self._seed = seed
        self._horizon = horizon
        self._envs: Dict[int, Any] = {}   # lane count -> VectorEnv
        probe = make_vector_env(env, 1, seed=seed)
        self.obs_dim = probe.observation_dim
        self.num_actions = probe.num_actions
        self.action_dim = getattr(probe, "action_dim", 0)
        self._shapes = _mlp_shapes(self.obs_dim, self._hidden,
                                   self.num_actions or self.action_dim)

    def _get_env(self, lanes: int):
        env = self._envs.get(lanes)
        if env is None:
            env = make_vector_env(self._env_spec, lanes, seed=self._seed)
            self._envs[lanes] = env
        return env

    def _act(self, layers: list, x: np.ndarray) -> np.ndarray:
        """One env step's actions: [B] ints (argmax, first index on
        ties) or [B, action_dim] f32 (tanh)."""
        out = population_forward(
            layers, torch.from_numpy(x).to(self.device))
        act = out.argmax(-1) if self.num_actions else torch.tanh(out)
        return act.cpu().numpy()

    def evaluate(self, theta: np.ndarray, seeds: List[int], sigma: float,
                 obs_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None
                 ) -> Dict[str, Any]:
        """Antithetic evaluation: returns per-seed (r_plus, r_minus),
        episode lengths, and observation moments (for ARS-V2 filters).
        `obs_stats=(mean, std)` normalizes observations when given."""
        theta = np.asarray(theta, np.float32)
        dim = theta.size
        k = len(seeds)
        eps = np.stack([_noise(s, dim) for s in seeds])       # [K, dim]
        pop = np.empty((2 * k, dim), np.float32)
        pop[0::2] = theta[None, :] + sigma * eps
        pop[1::2] = theta[None, :] - sigma * eps
        layers = population_layers(torch.from_numpy(pop).to(self.device),
                                   self._shapes)
        env = self._get_env(2 * k)
        obs = env.reset_all(seed=self._seed)
        active = np.ones(2 * k, bool)
        returns = np.zeros(2 * k, np.float64)
        lengths = np.zeros(2 * k, np.int64)
        o_sum = np.zeros(self.obs_dim, np.float64)
        o_sq = np.zeros(self.obs_dim, np.float64)
        o_n = 0
        for _ in range(self._horizon):
            o_sum += obs[active].sum(0)
            o_sq += (obs[active] ** 2).sum(0)
            o_n += int(active.sum())
            x = obs
            if obs_stats is not None:
                x = (obs - obs_stats[0]) / obs_stats[1]
            actions = self._act(layers, x.astype(np.float32))
            _obs, rew, term, trunc = env.step(actions)
            returns += rew * active
            lengths += active
            active &= ~(term | trunc)
            obs = _obs
            if not active.any():
                break
        env.drain_episode_metrics()  # masked lanes: `returns` counts
        return {"r_plus": returns[0::2], "r_minus": returns[1::2],
                "lengths": lengths, "obs_sum": o_sum, "obs_sq": o_sq,
                "obs_n": o_n}


def centered_ranks(x: np.ndarray) -> np.ndarray:
    """Rank transform to [-0.5, 0.5]; numpy's argsort orders the ties,
    as in the reference."""
    flat = x.ravel()
    ranks = np.empty(flat.size, dtype=np.float64)
    ranks[flat.argsort()] = np.arange(flat.size)
    ranks = ranks / (flat.size - 1) - 0.5
    return ranks.reshape(x.shape)


class ESConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=ES)
        self.num_rollout_workers = 2
        self.episodes_per_batch = 32     # perturbation DIRECTIONS per iter
        self.noise_stdev = 0.05
        self.lr = 0.02
        self.l2_coeff = 0.005
        self.episode_horizon = 500
        self.model_hidden = (32, 32)


class ES(Algorithm):
    """Driver: sample direction seeds -> fan out to the worker fleet ->
    centered-rank gradient estimate -> Adam step on the flat vector."""

    def setup(self) -> None:
        cfg = self.config
        if cfg.runtime is None:
            raise ValueError(
                f"{type(self).__name__}'s evaluation workers need a runtime "
                f"handle: config.resources(runtime=ray_tpu)")
        resolve_device(cfg.device)      # refuse at build, not at train()
        self.theta = _init_flat(self.obs_dim, tuple(cfg.model_hidden),
                                self.num_actions or self.action_dim,
                                cfg.seed)
        self._rng = np.random.default_rng(cfg.seed)
        self._adam_m = np.zeros_like(self.theta)
        self._adam_v = np.zeros_like(self.theta)
        self._adam_t = 0
        remote_cls = cfg.runtime.remote(
            num_cpus=cfg.num_cpus_per_worker)(EvalWorker)
        self.workers = [
            remote_cls.remote(env=shippable_env(cfg.env),
                              hidden=tuple(cfg.model_hidden),
                              seed=cfg.seed + 7919 * (i + 1),
                              horizon=cfg.episode_horizon, device=cfg.device)
            for i in range(max(1, cfg.num_rollout_workers))]

    def _fan_out(self, seeds: np.ndarray, obs_stats=None):
        n = len(self.workers)
        shards = np.array_split(seeds, n)
        refs = [w.evaluate.remote(self.theta, [int(s) for s in shard],
                                  self.config.noise_stdev, obs_stats)
                for w, shard in zip(self.workers, shards) if len(shard)]
        return (self.config.runtime.get(refs, timeout=EVAL_TIMEOUT_S),
                [s for s in shards if len(s)])

    def _record(self, results, r_plus, r_minus) -> int:
        """Fold a round's returns and lengths into the metrics window;
        returns its episode count."""
        all_returns = np.concatenate([r_plus, r_minus])
        lengths = np.concatenate([r["lengths"] for r in results])
        self._episode_returns.extend(all_returns.tolist())
        self._episode_lengths.extend(lengths.tolist())
        self.total_env_steps += int(lengths.sum())
        return int(all_returns.size)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n_dir = cfg.episodes_per_batch
        seeds = self._rng.integers(0, 2 ** 31 - 1, size=n_dir)
        results, shards = self._fan_out(seeds)
        r_plus = np.concatenate([r["r_plus"] for r in results])
        r_minus = np.concatenate([r["r_minus"] for r in results])
        used = np.concatenate(shards)
        # Utilities from the CENTERED RANKS of all 2n returns.
        ranks = centered_ranks(np.stack([r_plus, r_minus]))
        weights = ranks[0] - ranks[1]                          # [n_dir]
        eps = np.stack([_noise(s, self.theta.size) for s in used])
        grad = (weights[:, None] * eps).sum(0) / (
            n_dir * cfg.noise_stdev)
        grad = grad - cfg.l2_coeff * self.theta                # weight decay
        # Adam ascent on the flat vector (f64 moments from the first step).
        self._adam_t += 1
        b1, b2, eps_ = 0.9, 0.999, 1e-8
        self._adam_m = b1 * self._adam_m + (1 - b1) * grad
        self._adam_v = b2 * self._adam_v + (1 - b2) * grad * grad
        mh = self._adam_m / (1 - b1 ** self._adam_t)
        vh = self._adam_v / (1 - b2 ** self._adam_t)
        self.theta += cfg.lr * mh / (np.sqrt(vh) + eps_)
        return {"episodes_this_iter": self._record(results, r_plus, r_minus),
                "update_norm": float(np.linalg.norm(grad)),
                "theta_norm": float(np.linalg.norm(self.theta))}

    def save_to_dict(self) -> Dict[str, Any]:
        # Copies: theta and the moments change in place after a save.
        return {"theta": self.theta.copy(), "adam_m": self._adam_m.copy(),
                "adam_v": self._adam_v.copy(), "adam_t": self._adam_t}

    def restore_from_dict(self, state: Dict[str, Any]) -> None:
        self.theta = np.array(state["theta"])
        self._adam_m = np.array(state["adam_m"])
        self._adam_v = np.array(state["adam_v"])
        self._adam_t = state["adam_t"]

    def stop(self) -> None:
        for w in self.workers:
            try:
                self.config.runtime.kill(w)
            except Exception:   # already gone; stop() is best effort
                pass
