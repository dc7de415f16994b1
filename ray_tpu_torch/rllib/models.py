"""Policy/value networks for the RL stack (port of ray_tpu/rllib/models.py),
as `nn.Module`s: the actor-critics (tanh MLP, Nature-CNN, diagonal
Gaussian), SAC's squashed-Gaussian actor, TD3's deterministic actor, the
Q(s, a) network, and the recurrent (LSTM) actor-critic.

The flax modules' submodules carry the flax param tree's names
(`Dense_0`, ..., `Conv_0`, ..., the free `log_std`), so
`convert.actor_critic_state_dict` / `actor_critic_variables` carry
weights across by name; only the layouts change (a flax Dense kernel is
[in, out], a Linear weight [out, in]; a flax Conv kernel is HWIO, a
Conv2d weight OIHW).  The recurrent model is the reference's plain dict
(`enc[i].{w,b}`, `lstm.{wx,wh,b}`, `pi`, `vf`), kept [in, out].

What flax does that torch's defaults do not, in the Nature-CNN:
- `nn.Conv` pads "SAME" by default: 84 -> 21 -> 11 -> 11, not the
  84 -> 20 -> 9 -> 7 of unpadded convolutions; `_pad_same` pads
  explicitly (the odd pixel at the bottom and right);
- the flatten before `Dense(512)` runs over NHWC, so the activations are
  permuted back to NHWC before it, or the 7,744 x 512 kernel would meet
  its inputs in another order.

The recurrent model's cell is the reference's hand-rolled LSTM: gates
i/f/g/o in that order (PyTorch's order too), the forget gate
sigmoid(f + 1), one bias.  cuDNN's `nn.LSTM` has two biases and cannot
zero the carry inside a sequence, so `apply_seq` loops over T in plain
ops, zeroing the carry before step t wherever `resets[t]` holds.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.resnet import _same


def _orthogonal(layer: nn.Linear, gain: float, gen: torch.Generator):
    nn.init.orthogonal_(layer.weight, gain=gain, generator=gen)
    nn.init.zeros_(layer.bias)
    return layer


def _lecun_normal(layer: nn.Module, gen: torch.Generator):
    """flax's default kernel init: a normal of variance 1 / fan_in,
    truncated at two standard deviations (and rescaled for the cut)."""
    fan_in = layer.weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std,
                          generator=gen)
    nn.init.zeros_(layer.bias)
    return layer


class ActorCritic(nn.Module):
    """Separate-trunk tanh MLP actor-critic with orthogonal init.

    forward(obs [B, D]) -> (logits [B, A], value [B])."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        sizes = [int(obs_dim), *hidden]
        n = len(hidden)
        # flax numbers Dense layers in creation order: the policy trunk,
        # the logits, then the value trunk and the value head.
        for i in range(n):
            self.add_module(f"Dense_{i}", _orthogonal(
                nn.Linear(sizes[i], sizes[i + 1]), math.sqrt(2), gen))
        self.add_module(f"Dense_{n}", _orthogonal(
            nn.Linear(sizes[-1], num_actions), 0.01, gen))
        for i in range(n):
            self.add_module(f"Dense_{n + 1 + i}", _orthogonal(
                nn.Linear(sizes[i], sizes[i + 1]), math.sqrt(2), gen))
        self.add_module(f"Dense_{2 * n + 1}", _orthogonal(
            nn.Linear(sizes[-1], 1), 1.0, gen))
        self._n = n

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        layers = list(self.children())
        n = self._n
        x = obs
        for layer in layers[:n]:
            x = torch.tanh(layer(x))
        logits = layers[n](x)
        v = obs
        for layer in layers[n + 1:2 * n + 1]:
            v = torch.tanh(layer(v))
        return logits, layers[2 * n + 1](v)[..., 0]


class ConvActorCritic(nn.Module):
    """Nature-CNN actor-critic for image observations: conv 32x8s4,
    64x4s2, 64x3s1 (SAME), dense 512, one trunk and two heads.  Inputs
    are [B, H, W, C] in [0, 255] (uint8 or float); scaling to [0, 1]
    happens inside, so rollout buffers stay uint8."""

    CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))   # (filters, k, stride)

    def __init__(self, obs_shape: Sequence[int], num_actions: int,
                 dense: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        h, w, c = (int(s) for s in obs_shape)
        for i, (f, k, s) in enumerate(self.CONVS):
            self.add_module(f"Conv_{i}", _lecun_normal(
                nn.Conv2d(c, f, k, stride=s), gen))
            h, w, c = -(-h // s), -(-w // s), f
        self.add_module("Dense_0", _lecun_normal(
            nn.Linear(h * w * c, dense), gen))
        self.add_module("Dense_1", _orthogonal(
            nn.Linear(dense, num_actions), 0.01, gen))
        self.add_module("Dense_2", _orthogonal(nn.Linear(dense, 1), 1.0,
                                               gen))

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        x = obs.float().div(255.0).permute(0, 3, 1, 2)      # NCHW
        for i, (_, k, s) in enumerate(self.CONVS):
            (top, bottom), (left, right) = (_same(x.shape[2], k, s),
                                            _same(x.shape[3], k, s))
            x = F.pad(x, (left, right, top, bottom))
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x), self.Dense_2(x)[..., 0]


def make_model(obs_dim, num_actions: int, hidden: Sequence[int] = (64, 64),
               *, seed: int = 0, device: DeviceLike = None) -> nn.Module:
    """The actor-critic for an observation space, on `device` (None ->
    CUDA): an int `obs_dim` is a flat observation (the MLP), a shape
    tuple (H, W, C) an image (the Nature-CNN), as the reference
    dispatches.  Weights are drawn on the CPU from `seed`."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    if isinstance(obs_dim, (tuple, list)) and len(obs_dim) > 1:
        model = ConvActorCritic(obs_dim, num_actions, generator=gen)
    else:
        model = ActorCritic(int(obs_dim), num_actions, tuple(hidden),
                            generator=gen)
    return model.to(device)


class GaussianActorCritic(nn.Module):
    """Diagonal-Gaussian policy for continuous control: tanh MLP trunk ->
    action mean, a state-independent learned `log_std` (zeros at init),
    and a separate value trunk, with orthogonal init.

    forward(obs [B, D]) -> (mean [B, A], log_std [A], value [B])."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        sizes = [int(obs_dim), *hidden]
        n = len(hidden)
        for i in range(n):
            self.add_module(f"Dense_{i}", _orthogonal(
                nn.Linear(sizes[i], sizes[i + 1]), math.sqrt(2), gen))
        self.add_module(f"Dense_{n}", _orthogonal(
            nn.Linear(sizes[-1], action_dim), 0.01, gen))
        self.log_std = nn.Parameter(torch.zeros(action_dim))
        for i in range(n):
            self.add_module(f"Dense_{n + 1 + i}", _orthogonal(
                nn.Linear(sizes[i], sizes[i + 1]), math.sqrt(2), gen))
        self.add_module(f"Dense_{2 * n + 1}", _orthogonal(
            nn.Linear(sizes[-1], 1), 1.0, gen))
        self._n = n

    def forward(self, obs: torch.Tensor):
        layers = list(self.children())
        n = self._n
        x = obs
        for layer in layers[:n]:
            x = torch.tanh(layer(x))
        mean = layers[n](x)
        v = obs
        for layer in layers[n + 1:2 * n + 1]:
            v = torch.tanh(layer(v))
        return mean, self.log_std, layers[2 * n + 1](v)[..., 0]


def make_continuous_model(obs_dim: int, action_dim: int,
                          hidden: Sequence[int] = (64, 64), *,
                          seed: int = 0,
                          device: DeviceLike = None) -> nn.Module:
    """A `GaussianActorCritic` on `device` (None -> CUDA), its weights
    drawn on the CPU from `seed`."""
    gen = torch.Generator().manual_seed(int(seed))
    return GaussianActorCritic(int(obs_dim), action_dim, tuple(hidden),
                               generator=gen).to(resolve_device(device))


def gaussian_logp(mean, log_std, actions):
    """Diagonal-Gaussian log prob, summed over action dims."""
    var = torch.exp(2 * log_std)
    return torch.sum(-0.5 * ((actions - mean) ** 2 / var) - log_std
                     - 0.5 * math.log(2 * math.pi), dim=-1)


def _relu_trunk(module: nn.Module, sizes, gen) -> int:
    """Dense_0 .. Dense_{n-1} with flax's default init; returns n."""
    for i in range(len(sizes) - 1):
        module.add_module(f"Dense_{i}", _lecun_normal(
            nn.Linear(sizes[i], sizes[i + 1]), gen))
    return len(sizes) - 1


def _run_relu_trunk(module: nn.Module, n: int, x: torch.Tensor):
    for i in range(n):
        x = F.relu(getattr(module, f"Dense_{i}")(x))
    return x


class SquashedGaussianActor(nn.Module):
    """SAC's actor: relu trunk -> state-dependent (mean, log_std), log_std
    clipped to [-20, 2]; actions are tanh-squashed samples.

    forward(obs [B, D]) -> (mean [B, A], log_std [B, A])."""

    LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        n = _relu_trunk(self, [int(obs_dim), *hidden], gen)
        self.add_module(f"Dense_{n}", _lecun_normal(
            nn.Linear(hidden[-1], action_dim), gen))
        self.add_module(f"Dense_{n + 1}", _lecun_normal(
            nn.Linear(hidden[-1], action_dim), gen))
        self._n = n

    def forward(self, obs: torch.Tensor):
        x = _run_relu_trunk(self, self._n, obs)
        mean = getattr(self, f"Dense_{self._n}")(x)
        log_std = getattr(self, f"Dense_{self._n + 1}")(x)
        return mean, torch.clamp(log_std, self.LOG_STD_MIN,
                                  self.LOG_STD_MAX)


class DeterministicActor(nn.Module):
    """TD3's actor: relu trunk -> tanh action in [-1, 1] (the caller
    scales it to the env's bounds)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        n = _relu_trunk(self, [int(obs_dim), *hidden], gen)
        self.add_module(f"Dense_{n}", _lecun_normal(
            nn.Linear(hidden[-1], action_dim), gen))
        self._n = n

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = _run_relu_trunk(self, self._n, obs)
        return torch.tanh(getattr(self, f"Dense_{self._n}")(x))


class QNetwork(nn.Module):
    """Continuous-action state-action value: Q(concat(obs, action)) -> [B]."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        n = _relu_trunk(self, [int(obs_dim) + action_dim, *hidden], gen)
        self.add_module(f"Dense_{n}", _lecun_normal(
            nn.Linear(hidden[-1], 1), gen))
        self._n = n

    def forward(self, obs: torch.Tensor,
                action: torch.Tensor) -> torch.Tensor:
        x = _run_relu_trunk(self, self._n, torch.cat([obs, action], -1))
        return getattr(self, f"Dense_{self._n}")(x)[..., 0]


def make_offpolicy_model(kind: str, obs_dim: int, action_dim: int,
                         hidden: Sequence[int] = (256, 256), *,
                         seed: int = 0,
                         device: DeviceLike = None) -> nn.Module:
    """SAC's and TD3's networks by `kind` ("squashed", "deterministic" or
    "q") on `device` (None -> CUDA), drawn on the CPU from `seed`."""
    cls = {"squashed": SquashedGaussianActor,
           "deterministic": DeterministicActor, "q": QNetwork}[kind]
    gen = torch.Generator().manual_seed(int(seed))
    return cls(int(obs_dim), action_dim, tuple(hidden),
               generator=gen).to(resolve_device(device))


# ------------------------------------------------------------- recurrent

class _Affine(nn.Module):
    """x @ w + b, with w kept [in, out] as the reference's dict keeps it;
    w ~ normal * scale, b = 0."""

    def __init__(self, n_in: int, n_out: int, scale: float,
                 gen: torch.Generator):
        super().__init__()
        self.w = nn.Parameter(torch.randn(n_in, n_out, generator=gen)
                              * scale)
        self.b = nn.Parameter(torch.zeros(n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class _LSTMParams(nn.Module):
    def __init__(self, n_in: int, size: int, gen: torch.Generator):
        super().__init__()
        self.wx = nn.Parameter(torch.randn(n_in, 4 * size, generator=gen)
                               * math.sqrt(1.0 / n_in))
        self.wh = nn.Parameter(torch.randn(size, 4 * size, generator=gen)
                               * math.sqrt(1.0 / size))
        self.b = nn.Parameter(torch.zeros(4 * size))


def lstm_gates(z: torch.Tensor, c: torch.Tensor):
    """One LSTM cell update from the pre-activations z = x·wx + h·wh + b:
    gates i/f/g/o in that order, forget gate sigmoid(f + 1).  Returns
    (h, c)."""
    i, f, g, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


class RecurrentActorCritic(nn.Module):
    """A tanh encoder feeding an LSTM whose state threads through
    state_in / state_out, a policy head and a value head on h.

    - step(obs [B, D], state [2, B, H]) -> (logits [B, A], value [B],
      state_out [2, B, H]): rollout inference;
    - apply_seq(obs [T, B, D], state0 [2, B, H], resets [T, B] bool) ->
      (logits [T, B, A], values [T, B]): training over a chunk, the carry
      zeroed before step t wherever resets[t] holds;
    - initial_state(batch) -> numpy zeros [2, batch, H]."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64,), lstm_size: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        n_in = int(obs_dim)
        enc = []
        for h in hidden:
            enc.append(_Affine(n_in, h, math.sqrt(2.0 / n_in), gen))
            n_in = h
        self.enc = nn.ModuleList(enc)
        self.lstm = _LSTMParams(n_in, lstm_size, gen)
        self.pi = _Affine(lstm_size, num_actions, 0.01, gen)
        self.vf = _Affine(lstm_size, 1, 1.0, gen)
        self.lstm_size = lstm_size

    def _encode(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for layer in self.enc:
            x = torch.tanh(layer(x))
        return x

    def step(self, obs: torch.Tensor, state: torch.Tensor):
        x = self._encode(obs)
        p = self.lstm
        h, c = lstm_gates(x @ p.wx + state[0] @ p.wh + p.b, state[1])
        return self.pi(h), self.vf(h)[..., 0], torch.stack([h, c])

    def apply_seq(self, obs: torch.Tensor, state0: torch.Tensor,
                  resets: torch.Tensor):
        p = self.lstm
        xw = self._encode(obs) @ p.wx               # [T, B, 4H], one matmul
        keep = (~resets.bool())[..., None].to(xw.dtype)
        h, c = state0[0], state0[1]
        hs = []
        for t in range(xw.shape[0]):
            h, c = h * keep[t], c * keep[t]
            h, c = lstm_gates(xw[t] + h @ p.wh + p.b, c)
            hs.append(h)
        hs = torch.stack(hs)
        return self.pi(hs), self.vf(hs)[..., 0]

    def initial_state(self, batch: int) -> np.ndarray:
        return np.zeros((2, batch, self.lstm_size), np.float32)


def make_recurrent_model(obs_dim: int, num_actions: int,
                         hidden: Sequence[int] = (64,),
                         lstm_size: int = 64, *, seed: int = 0,
                         device: DeviceLike = None) -> RecurrentActorCritic:
    """A `RecurrentActorCritic` on `device` (None -> CUDA), its weights
    drawn on the CPU from `seed` with the reference's scales (encoder
    sqrt(2 / fan_in), wx sqrt(1 / fan_in), wh sqrt(1 / H), policy head
    0.01, value head 1.0; zero biases)."""
    gen = torch.Generator().manual_seed(int(seed))
    return RecurrentActorCritic(obs_dim, num_actions, tuple(hidden),
                                lstm_size, generator=gen).to(
        resolve_device(device))
