"""TorchLearner: minibatch SGD on sample batches (port of
ray_tpu/rllib/learner.py's single-device `JaxLearner`), and the PPO
losses: categorical (`ppo_loss`), diagonal Gaussian
(`ppo_loss_continuous`) and over LSTM sequence chunks
(`ppo_loss_recurrent`).

The reference jits the whole update (a lax.scan over minibatches inside
one over epochs); here it is a Python loop over the same epochs and
minibatches, each minibatch one forward, one backward and one optimizer
step.  The permutations are the learner's own draws (a torch.Generator
from `seed + 17`), not `jax.random`'s, so the two packages agree per
minibatch step, not over a shuffled epoch.

The optimizer is optax's `chain(clip_by_global_norm(grad_clip),
adam(lr, eps=1e-5))`, written out (`ClipAdam`) in optax's arithmetic:
- the global norm clips as `g / g_norm * max_norm`, and only when
  `g_norm >= max_norm` (torch's `clip_grad_norm_` scales by
  `max_norm / (g_norm + 1e-6)`, always);
- Adam adds eps outside the square root and corrects the bias from the
  incremented count; no weight decay.
With `max_norm=None` and `eps=1e-8` it is plain `optax.adam(lr)`, the
optimizer of SAC and TD3.

The learner's model follows the reference's choice: `model="lstm"` the
recurrent actor-critic (minibatch rows are then sequences), a continuous
env (`num_actions == 0`, `action_dim > 0`) the Gaussian actor-critic,
else the MLP or the Nature-CNN.

Data-parallel (`mesh` with `data` = k > 1, built inside each rank of a
process group; the reference's shard_map with a gradient pmean): every
rank holds the whole batch and draws the same permutation (its
generator seeded alike), the advantages are normalised over each global
minibatch of `mb_rows = (min(mb_size, n) // k) * k` rows before the
rank takes its `mb_rows // k` of them, and the gradients and metrics
are averaged over `data` before `ClipAdam`'s clip and step, so a dp-k
learner walks one device's trajectory up to the order of its sums.  A
mesh with any other axis above 1 raises ("data-parallel only").  Across
processes the learner is a group of such ranks (`learner_group.py`).
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import convert
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import AXES, MeshConfig, axis_sizes
from ray_tpu_torch.rllib.models import (gaussian_logp,
                                        make_continuous_model, make_model,
                                        make_recurrent_model)
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def learner_mesh_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a `learner_mesh`: the port's `MeshConfig` (every
    axis given, no -1) or anything `axis_sizes` reads (a DeviceMesh, an
    object with a `.shape` mapping).  Any axis above 1 but `data` raises
    ValueError ("data-parallel only")."""
    if isinstance(mesh, MeshConfig):
        sizes = {a: getattr(mesh, a) for a in AXES}
        if -1 in sizes.values():
            raise ValueError(f"learner_mesh {mesh}: give every axis's size "
                             f"(no -1)")
    else:
        sizes = axis_sizes(mesh)
    bad = [a for a, s in sizes.items() if s > 1 and a != "data"]
    if bad:
        raise ValueError(
            f"the RL learner is data-parallel only; mesh axes {bad} have "
            f"size > 1 (shard the model with models/, not the RL learner)")
    return sizes


class DataParallel:
    """This rank's place among the data-parallel replicas of a learner on
    `mesh`: `group` over `data` (None on one device), its size `k` and
    the rank's `index` in it.  A mesh with any other axis above 1 raises
    ValueError, as the reference's learner does (`learner_mesh_sizes`);
    `mesh` is None, a DeviceMesh, or anything with a `.shape` mapping
    whose axes are all 1 (one device)."""

    def __init__(self, mesh, who: str):
        self.k = 1 if mesh is None else \
            learner_mesh_sizes(mesh).get("data", 1)
        self.group, self.index = None, 0
        if self.k > 1:
            if not hasattr(mesh, "mesh_dim_names"):
                raise TypeError(
                    f"{who} with data = {self.k} is built on each rank of a "
                    f"process group with a DeviceMesh (create_mesh); an "
                    f"algorithm's learner_mesh starts such a group itself")
            self.group = collectives.axis_group(mesh, ("data",))
            self.index = dict(zip(mesh.mesh_dim_names,
                                  mesh.get_coordinate()))["data"]


def normalize_advantages(adv: torch.Tensor) -> torch.Tensor:
    """Over every element of a minibatch (its rows, and a recurrent
    batch's time axis), std with ddof 0."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def batch_tensors(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """A SampleBatch's columns as tensors on `device`, dtypes kept (uint8
    frames stay bytes).  A read-only column (one the object store handed
    over) is copied first."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(a if a.flags.writeable
                                  else a.copy()).to(device)
    return out


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: every gradient scaled by
    max_norm / g_norm when the global norm g_norm >= max_norm, else
    left as it is.  Decided on the device, without a host sync."""
    g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = g_norm < max_norm
    one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
    denom = torch.where(keep, one, g_norm)
    numer = torch.where(keep, one, torch.full_like(one, max_norm))
    return [g / denom * numer for g in grads]


class ClipAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr, eps=1e-5))
    over `params`, updated in place; with `max_norm=None` no clip, and
    with `eps=1e-8` then optax.adam(lr).  `decay_steps` makes the
    learning rate optax's linear_schedule(lr, 0.0, decay_steps).  State:
    `count` (host int) and the moments `mu`, `nu` (one tensor per
    param)."""

    B1, B2 = 0.9, 0.999

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 max_norm: Optional[float],
                 decay_steps: Optional[int] = None, eps: float = 1e-5):
        self.params = list(params)
        self.lr = float(lr)
        self.max_norm = None if max_norm is None else float(max_norm)
        self.eps = eps
        self.decay_steps = decay_steps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def lr_at(self, count: int) -> float:
        if self.decay_steps is None:
            return self.lr
        frac = 1.0 - min(max(count, 0), self.decay_steps) / self.decay_steps
        return self.lr * frac

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        lr = self.lr_at(self.count)
        self.count += 1
        bc1 = 1.0 - self.B1 ** self.count
        bc2 = 1.0 - self.B2 ** self.count
        if self.max_norm is not None:
            grads = clip_by_global_norm(grads, self.max_norm)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.B1).add_(g, alpha=1.0 - self.B1)
            v.mul_(self.B2).addcmul_(g, g, value=1.0 - self.B2)
            u = (m / bc1) / ((v / bc2).sqrt_() + self.eps)
            p.add_(u, alpha=-lr)


def make_learner_model(obs_dim, num_actions: int, hidden, *, seed: int,
                       device: torch.device, action_dim: int = 0,
                       model: str = "fc", lstm_size: int = 64):
    """The model a learner trains, chosen as the reference chooses it:
    "lstm" the recurrent actor-critic, a continuous env the Gaussian
    actor-critic, else the MLP or the Nature-CNN."""
    if model == "lstm":
        return make_recurrent_model(obs_dim, num_actions, hidden, lstm_size,
                                    seed=seed, device=device)
    if model != "fc":
        raise ValueError(f"unknown model {model!r}")
    if num_actions == 0 and action_dim > 0:
        return make_continuous_model(obs_dim, action_dim, hidden,
                                     seed=seed, device=device)
    return make_model(obs_dim, num_actions, hidden, seed=seed,
                      device=device)


class TorchLearner:
    """Minibatch-SGD learner over an actor-critic model.

    loss_fn(model, minibatch, cfg) -> (loss, metrics) is supplied by the
    algorithm (the PPO losses below, `a2c_loss`); the minibatch is a dict
    of tensors on the learner's device.  `device=None` means CUDA.
    """

    def __init__(self, obs_dim, num_actions: int, *,
                 loss_fn: Callable, config: Dict[str, Any],
                 hidden=(64, 64), seed: int = 0,
                 mesh: Optional[Any] = None, action_dim: int = 0,
                 model: str = "fc", lstm_size: int = 64,
                 device: DeviceLike = None):
        self.dp = DataParallel(mesh, "TorchLearner")
        self.device = resolve_device(device)
        self.config = config
        # A replica's rows are a slice of the global minibatch, whose
        # advantages `update` normalises before the slice.
        self._loss_config = config if self.dp.k == 1 else dict(
            config, advantages_prenormalized=True)
        self.model = make_learner_model(
            obs_dim, num_actions, hidden, seed=seed, device=self.device,
            action_dim=action_dim, model=model, lstm_size=lstm_size)
        self.opt = ClipAdam(
            self.model.parameters(), config.get("lr", 3e-4),
            config.get("grad_clip", 0.5),
            (config.get("lr_decay_steps", 1000)
             if config.get("lr_schedule") == "linear" else None))
        self._loss_fn = loss_fn
        self._gen = torch.Generator().manual_seed(seed + 17)
        self._lock = threading.Lock()

    def minibatch_step(self, mb: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """One loss, backward and optimizer step on one minibatch; the
        gradients and metrics averaged over the data-parallel replicas
        first.  Returns the metrics as device scalars."""
        params = self.opt.params
        loss, metrics = self._loss_fn(self.model, mb, self._loss_config)
        grads = list(torch.autograd.grad(loss, params))
        keys = list(metrics)
        means = collectives.all_reduce_mean(
            grads + [metrics[k].detach() for k in keys], self.dp.group)
        with self._lock:
            self.opt.step(means[:len(grads)])
        return dict(zip(keys, means[len(grads):]))

    def _permutation(self, n: int) -> torch.Tensor:
        """An epoch's shuffle of the batch's n rows (the same on every
        data-parallel replica)."""
        return torch.randperm(n, generator=self._gen)

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        tb = batch_tensors(batch, self.device)
        n = next(iter(tb.values())).shape[0]
        mb_size = self.config.get("sgd_minibatch_size", 128)
        num_mb = max(n // mb_size, 1)
        k, index = self.dp.k, self.dp.index
        rows = (min(mb_size, n) // k) * k
        local = slice(index * rows // k, (index + 1) * rows // k)
        metrics: List[Dict[str, torch.Tensor]] = []
        for _ in range(self.config.get("num_sgd_iter", 1)):
            perm = self._permutation(n).to(self.device)
            for i in range(num_mb):
                idx = perm[i * rows:(i + 1) * rows]
                mb = {key: v[idx] for key, v in tb.items()}
                if k > 1:
                    if SampleBatch.ADVANTAGES in mb:
                        mb[SampleBatch.ADVANTAGES] = normalize_advantages(
                            mb[SampleBatch.ADVANTAGES])
                    mb = {key: v[local] for key, v in mb.items()}
                metrics.append(self.minibatch_step(mb))
        keys = list(metrics[0])
        means = torch.stack([torch.stack([m[k] for m in metrics]).mean()
                             for k in keys]).tolist()
        return dict(zip(keys, means))

    def get_weights(self):
        with self._lock:
            return convert.actor_critic_variables(self.model)

    def set_weights(self, weights) -> None:
        sd = convert.actor_critic_state_dict(weights, self.model)
        with self._lock:
            self.model.load_state_dict(sd)

    def get_state(self) -> Dict[str, Any]:
        return learner_state(self)

    def set_state(self, state: Dict[str, Any]) -> None:
        set_learner_state(self, state)


def learner_state(learner) -> Dict[str, Any]:
    """{"params", "opt_state"} of a learner with `.model`, `.opt`
    (ClipAdam) and `._lock`, in the reference's layout (numpy)."""
    opt = learner.opt
    with learner._lock:
        return {"params": convert.actor_critic_variables(learner.model),
                "opt_state": convert.rl_opt_state_tree(
                    opt.count, opt.mu, opt.nu, learner.model,
                    schedule=opt.decay_steps is not None)}


def set_learner_state(learner, state: Dict[str, Any]) -> None:
    """Load {"params", "opt_state"} (either package's layout) into such a
    learner."""
    sd = convert.actor_critic_state_dict(state["params"], learner.model)
    count, mu, nu = convert.rl_adam_state(state["opt_state"], learner.model)
    with learner._lock:
        learner.model.load_state_dict(sd)
        learner.opt.count = count
        for dst, src in zip(learner.opt.mu + learner.opt.nu, mu + nu):
            dst.copy_(src)


def policy_terms(model, mb, cfg=None):
    """Shared per-minibatch terms: (values, taken-action logp, normalized
    advantages, entropy) — used by the PPO loss."""
    logits, values = model(mb[SampleBatch.OBS])
    logp_all = F.log_softmax(logits, dim=-1)
    actions = mb[SampleBatch.ACTIONS].long()
    logp = logp_all.gather(1, actions[:, None])[:, 0]
    adv = mb[SampleBatch.ADVANTAGES]
    if not (cfg or {}).get("advantages_prenormalized"):
        adv = normalize_advantages(adv)
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    return values, logp, adv, entropy


def _ppo_surrogate(mb, cfg, values, logp, entropy) -> Tuple[torch.Tensor,
                                                            Dict]:
    """Clipped surrogate + clamped squared vf error (zero-gradding
    outliers past vf_clip_param), as the reference assembles them."""
    clip = cfg.get("clip_param", 0.2)
    vf_clip = cfg.get("vf_clip_param", 100.0)
    vf_coeff = cfg.get("vf_loss_coeff", 0.5)
    ent_coeff = cfg.get("entropy_coeff", 0.0)

    adv = mb[SampleBatch.ADVANTAGES]
    if not cfg.get("advantages_prenormalized"):
        adv = normalize_advantages(adv)
    ratio = torch.exp(logp - mb[SampleBatch.ACTION_LOGP])
    surr = torch.minimum(ratio * adv,
                         torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    policy_loss = -surr.mean()
    vf_loss = torch.clamp(
        (values - mb[SampleBatch.VALUE_TARGETS]) ** 2, max=vf_clip).mean()
    total = policy_loss + vf_coeff * vf_loss - ent_coeff * entropy
    return total, {"total_loss": total, "policy_loss": policy_loss,
                   "vf_loss": vf_loss, "entropy": entropy,
                   "kl": (mb[SampleBatch.ACTION_LOGP] - logp).mean()}


def ppo_loss(model, mb, cfg) -> Tuple[torch.Tensor, Dict]:
    """Clipped-surrogate PPO loss (categorical actions)."""
    values, logp, _adv, entropy = policy_terms(model, mb)
    return _ppo_surrogate(mb, cfg, values, logp, entropy)


def ppo_loss_recurrent(model, mb, cfg) -> Tuple[torch.Tensor, Dict]:
    """Clipped-surrogate PPO over LSTM sequence chunks.  Minibatch rows
    are sequences: OBS [b, T, D], actions / logp / advantages / targets
    [b, T], resets [b, T], state_in [b, 2, H]; the chunk is replayed from
    state_in with the carry zeroed at the resets."""
    obs = mb[SampleBatch.OBS].movedim(0, 1)              # [T, b, D]
    resets = mb["resets"].t()                            # [T, b]
    state0 = mb["state_in"].movedim(0, 1)                # [2, b, H]
    logits, values = model.apply_seq(obs, state0, resets)
    logits = logits.movedim(0, 1)                        # [b, T, A]
    values = values.t()                                  # [b, T]
    logp_all = F.log_softmax(logits, dim=-1)
    actions = mb[SampleBatch.ACTIONS].long()
    logp = logp_all.gather(-1, actions[..., None])[..., 0]
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    return _ppo_surrogate(mb, cfg, values, logp, entropy)


def ppo_loss_continuous(model, mb, cfg) -> Tuple[torch.Tensor, Dict]:
    """Clipped-surrogate PPO for diagonal-Gaussian policies; the entropy
    is sum(log_std + 0.5 * log(2 * pi * e)), state-independent."""
    mean, log_std, values = model(mb[SampleBatch.OBS])
    logp = gaussian_logp(mean, log_std, mb[SampleBatch.ACTIONS])
    entropy = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
    return _ppo_surrogate(mb, cfg, values, logp, entropy)
