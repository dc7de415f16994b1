"""Weights and token batches drawn from the run's seed, on the device.

Every leaf has a generator of its own, seeded from (seed, leaf path), so
a leaf can be drawn again alone (the reference and the checks draw leaf
by leaf) and in any order.  A family's layout (each leaf's path, shape
and init scale) is its reference module's (`references/<name>.py`,
`leaf_specs`); this module draws any such layout.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

# {path: (shape, std)}: std None is a norm leaf, 1 for a path ending in
# "scale" and 0 otherwise; else N(0, std).
LeafSpecs = Dict[str, Tuple[tuple, Optional[float]]]


def derive_seed(seed: int, *parts) -> int:
    """A 63-bit generator seed from the run's seed and a name."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, device, *parts) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(derive_seed(seed, *parts))
    return g


def draw_leaf(specs: LeafSpecs, seed: int, path: str, device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Leaf `path` of `specs` drawn in f32 on `device`, then cast to
    `dtype`."""
    shape, std = specs[path]
    if std is None:
        fill = 1.0 if path.endswith("scale") else 0.0
        return torch.full(shape, fill, dtype=torch.float32, device=device)
    g = generator(seed, device, "weights", path)
    t = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return t.mul_(std).to(dtype)


def nest(flat: dict) -> dict:
    """{"blocks/wq": t, "tok_embed": t} -> {"blocks": {"wq": t}, ...}."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def draw_params(specs: LeafSpecs, matmul_leaves: Iterable[str], seed: int,
                device, *, matmul_dtype=torch.float32,
                keep: Optional[Callable] = None) -> dict:
    """The whole tree, in the order of `specs`: `matmul_leaves` (the
    matrices and tables) in `matmul_dtype` (the form a serving
    deployment loads: bf16), the others f32.  With `keep`, each leaf
    goes to `keep(path, leaf)` as soon as it is drawn and the tree holds
    what it returns."""
    matmul_leaves = set(matmul_leaves)
    flat = {}
    for path in specs:
        dtype = matmul_dtype if path in matmul_leaves else torch.float32
        t = draw_leaf(specs, seed, path, device, dtype)
        flat[path] = keep(path, t) if keep is not None else t
        del t
    return nest(flat)


def token_batch(seed: int, step: int, rows: int, length: int, vocab: int,
                device) -> torch.Tensor:
    """Training rows of step `step`: ids below `vocab` (the published
    vocabulary, under the padded table), int64 [rows, length]."""
    g = generator(seed, device, "batch", step)
    return torch.randint(0, vocab, (rows, length), generator=g,
                         device=device, dtype=torch.int64)
