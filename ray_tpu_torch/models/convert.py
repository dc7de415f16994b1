"""Carry weights across from the JAX reference.

The reference initialises with `jax.random`, whose draws no torch
generator reproduces, so the two packages compute the same thing only on
weights moved across: take the reference's GPT or Llama params as numpy
(`jax.tree.map(np.asarray, params)`) and turn them into the port's
params — same keys, same stacked layouts, same dtypes.  `params_to_numpy`
goes the other way, so the reference can be handed the port's weights
(or updated params compared leaf by leaf).
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import gpt, llama


def _tensor(arr) -> torch.Tensor:
    arr = np.array(arr, order="C")     # a writable copy the tensor owns
    if arr.dtype.name == "bfloat16":        # ml_dtypes: no numpy-native bf16
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


_SHAPES = {gpt.GPTConfig: gpt.param_shapes,
           llama.LlamaConfig: llama.param_shapes}


def params_from_numpy(tree: dict, config, device: DeviceLike = None) -> dict:
    """The reference's param tree (numpy leaves) of the family that
    `config` names (a `gpt.GPTConfig` or a `llama.LlamaConfig`) as the
    port's params on `device`.  Raises if a key or a shape differs from
    that family's `param_shapes(config)`."""
    device = resolve_device(device)
    if type(config) not in _SHAPES:
        raise TypeError(f"params_from_numpy: no model family for config "
                        f"{type(config).__name__}")

    def convert(sub, shapes, path):
        if set(sub) != set(shapes):
            raise ValueError(f"params{path}: keys {sorted(sub)} != "
                             f"expected {sorted(shapes)}")
        out = {}
        for key, want in shapes.items():
            if isinstance(want, dict):
                out[key] = convert(sub[key], want, f"{path}[{key!r}]")
                continue
            t = _tensor(sub[key])
            if tuple(t.shape) != want:
                raise ValueError(f"params{path}[{key!r}]: shape "
                                 f"{tuple(t.shape)} != expected {want}")
            out[key] = t.to(device)
        return out

    return convert(tree, _SHAPES[type(config)](config), "")


def params_to_numpy(params: dict) -> dict:
    """The inverse of `params_from_numpy`: the port's params as a tree of
    numpy arrays on the host (bf16 leaves as ml_dtypes' bfloat16)."""

    def convert(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy().copy()

    return {k: params_to_numpy(v) if isinstance(v, dict) else convert(v)
            for k, v in params.items()}
