"""The engine's in-step sampling, token-exact with the JAX reference.

The reference draws each lane's token with

    key = fold_in(jax.random.key(seed), counter)
    tok = jax.random.categorical(key, logits / max(temp, 1e-6))

(ray_tpu/inference/engine.py, `draw`), so sampled output is a function
of (request seed, tokens produced) alone.  A torch.Generator cannot give
those draws, so this module writes JAX's threefry2x32 path out in torch,
stage by stage, with `jax_threefry_partitionable=True` (the default of
the JAX the reference runs on):

    key(seed)          = (0, seed)                       # uint32 pair
    fold_in(key, data) = threefry2x32(key, (0, data))
    random_bits(key, n)= b1 ^ b2, (b1, b2) = threefry2x32(key, (0, iota(n)))
    uniform            = bitcast((bits >> 9) | 0x3F800000) - 1, mapped to
                         [minval, maxval) and floored at minval
    gumbel  (mode "low") = -log(-log(uniform(minval=tiny)))
    categorical        = argmax(gumbel + logits)

The uint32 arithmetic is done on int64 tensors, masked back to 32 bits
after every add (shifts stay below 2**62, so nothing overflows).  Keys
are pairs of int64 tensors of one shape; a batch of keys draws a batch of
rows at once.
"""

from __future__ import annotations

from typing import Tuple

import torch

Key = Tuple[torch.Tensor, torch.Tensor]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = torch.finfo(torch.float32).tiny


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (JAX's `threefry2x32_p`).  All
    arguments are int64 tensors holding uint32 values, broadcastable
    against each other."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _MASK
    b = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK
            b = (((b << r) & _MASK) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return a, b


def key(seed: torch.Tensor) -> Key:
    """`jax.random.key(seed)` for uint32 seeds: the pair (0, seed)."""
    seed = torch.as_tensor(seed).long() & _MASK
    return torch.zeros_like(seed), seed


def fold_in(k: Key, data: torch.Tensor) -> Key:
    """`jax.random.fold_in`: hash the count pair (0, data) under `k`."""
    data = torch.as_tensor(data, device=k[0].device).long() & _MASK
    return threefry2x32(k[0], k[1], torch.zeros_like(data), data)


def random_bits(k: Key, n: int) -> torch.Tensor:
    """`jax.random.bits(k, (n,), uint32)`: [..., n] int64 of uint32 values
    for keys of shape [...]."""
    k1, k2 = k[0][..., None], k[1][..., None]
    lo = torch.arange(n, device=k1.device, dtype=torch.int64)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(k: Key, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(k, (n,), float32, minval, maxval)`."""
    bits = random_bits(k, n)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(k: Key, n: int) -> torch.Tensor:
    """`jax.random.gumbel(k, (n,), float32)` in its default mode ("low")."""
    return -torch.log(-torch.log(uniform(k, n, minval=_TINY_F32)))


def categorical(k: Key, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(k, logits)` over the last axis of float32
    logits [..., V], keys of shape [...]: int64 [...]."""
    return torch.argmax(gumbel(k, logits.shape[-1]) + logits, dim=-1)


def sample(logits: torch.Tensor, temps: torch.Tensor, seeds: torch.Tensor,
           counters: torch.Tensor) -> torch.Tensor:
    """The engine's per-lane draw: logits [B, V] (any float dtype), temps
    [B] float32, seeds [B] (uint32 values), counters [B] -> int32 [B],
    each row drawn with fold_in(key(seed), counter)."""
    z = logits.float() / torch.clamp(temps, min=1e-6)[:, None]
    return categorical(fold_in(key(seeds), counters), z).to(torch.int32)
