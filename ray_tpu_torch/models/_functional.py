"""Shared train-step factory for the functional LM families (port of
ray_tpu/models/_functional.py, single device), and what the families'
modules share besides: the engine's working copy of the params and the
single-device check.

The reference's contract: `init_state` gives {"params", "opt_state",
"step"} and `train_step(state, batch)` gives (state, {"loss"}).  JAX's
step is a pure function; here the parameters and the optimizer's
moments are updated in place (the returned state holds the same
tensors), which saves a second copy of both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ray_tpu_torch._device import MULTI_DEVICE, DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class AdamW:
    """`optax.adamw`'s update: decoupled weight decay on every leaf,
    eps outside the square root, bias-corrected moments.  torch's AdamW
    computes the same update; only its default decay (1e-2) differs."""
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params: dict) -> torch.optim.Optimizer:
        leaves = _leaves(params)
        return torch.optim.AdamW(
            leaves, lr=self.learning_rate, betas=(self.b1, self.b2),
            eps=self.eps, weight_decay=self.weight_decay,
            fused=leaves[0].is_cuda)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> AdamW:
    """AdamW with `optax.adamw`'s defaults (weight_decay 1e-4)."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay)


def _leaves(tree: dict) -> list:
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def working_params(params: dict, dtype: torch.dtype, matmul_keys,
                   device: DeviceLike = None) -> dict:
    """The serving engine's copy of `params` on `device`, with every leaf
    named in `matmul_keys` (weights the forward only uses cast to the
    activation dtype: matmul weights and embedding tables) cast to
    `dtype` ONCE here, and every other leaf (the norms' scales and
    biases, which the forward mixes in at fp32) kept as it is.

    Casting fp32 -> bf16 once gives the same bits as the per-call
    `.to(h.dtype)` in the forward (which is then a no-op), so the numbers
    do not change."""
    device = resolve_device(device)
    return {k: working_params(v, dtype, matmul_keys, device)
            if isinstance(v, dict) else
            v.to(device=device, dtype=dtype if k in matmul_keys else v.dtype)
            for k, v in params.items()}


def check_single_device(mesh) -> None:
    """The port runs one device: a mesh with any axis above 1 raises.
    `mesh` is None or anything with a `.shape` mapping of axis sizes (a
    one-device mesh is accepted)."""
    if mesh is not None and any(s > 1 for s in dict(mesh.shape).values()):
        raise NotImplementedError(f"a mesh with an axis above 1 waits for "
                                  f"{MULTI_DEVICE}")



def make_train_step(config, optimizer: AdamW, *, init_params, loss_fn,
                    device: DeviceLike = None):
    """`init_params(config, generator, device)` and
    `loss_fn(params, batch, config, mesh)` define the family.

    `init_state(key=0, params=None)`: params from `init_params` with a
    generator seeded by `key` (an int or a torch.Generator), or a copy of
    `params` when given (e.g. weights carried across from the reference
    with convert.params_from_numpy).  `train_step(state, batch)` runs the
    loss, its backward and one optimizer step; the loss it returns is a
    device scalar (reading it waits for the step)."""
    device = resolve_device(device)

    def init_state(key: Union[int, torch.Generator] = 0,
                   params: Optional[dict] = None) -> dict:
        if params is None:
            gen = key if isinstance(key, torch.Generator) \
                else torch.Generator().manual_seed(int(key))
            params = init_params(config, gen, device=device)
        params = _map(params, lambda t: t.detach().to(
            device=device, dtype=torch.float32, copy=True).requires_grad_())
        return {"params": params, "opt_state": optimizer.init(params),
                "step": 0}

    def train_step(state: dict, batch: dict):
        params, opt = state["params"], state["opt_state"]
        opt.zero_grad(set_to_none=True)
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        loss = loss_fn(params, batch, config, None)
        loss.backward()
        opt.step()
        return ({"params": params, "opt_state": opt,
                 "step": state["step"] + 1},
                {"loss": loss.detach()})

    return init_state, train_step
