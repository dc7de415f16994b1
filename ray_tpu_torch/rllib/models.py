"""Policy/value networks for the RL stack (port of ray_tpu/rllib/models.py):
the feed-forward actor-critics of the discrete algorithms, as
`nn.Module`s.

Submodules carry the flax param tree's names (`Dense_0`, ..., `Conv_0`,
...), so `convert.actor_critic_state_dict` / `actor_critic_variables`
carry weights across by name; only the layouts change (a flax Dense
kernel is [in, out], a Linear weight [out, in]; a flax Conv kernel is
HWIO, a Conv2d weight OIHW).

What flax does that torch's defaults do not, in the Nature-CNN:
- `nn.Conv` pads "SAME" by default: 84 -> 21 -> 11 -> 11, not the
  84 -> 20 -> 9 -> 7 of unpadded convolutions; `_pad_same` pads
  explicitly (the odd pixel at the bottom and right);
- the flatten before `Dense(512)` runs over NHWC, so the activations are
  permuted back to NHWC before it, or the 7,744 x 512 kernel would meet
  its inputs in another order.

The continuous, squashed, deterministic, Q and recurrent models wait for
their algorithms (ROADMAP A9).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

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
