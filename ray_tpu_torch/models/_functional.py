"""Shared train-step factory for the functional LM families (port of
ray_tpu/models/_functional.py, single device).

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

from ray_tpu_torch._device import DeviceLike, resolve_device


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
