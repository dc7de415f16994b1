"""Weights and token batches drawn from the run's seed, on the device.

Every leaf has a generator of its own, seeded from (seed, leaf path), so
a leaf can be drawn again alone (the reference and the checks draw leaf
by leaf) and in any order.  The layout is the GPT family's stacked one:
the layers on a leading dim, `wq/wk/wv [n, d, h, dh]`, `wo [n, h, dh,
d]`, `w_up [n, d, f]`, `w_down [n, f, d]`, a tied embedding.  The scales
are GPT-2's published init: N(0, 0.02) for every matrix and the token
table, 0.02 / sqrt(2 n) for the residual projections (wo, w_down),
N(0, 0.01) for the position table, LayerNorm scale 1 and bias 0.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Optional, Tuple

import torch

MATMUL_LEAVES = ("tok_embed", "pos_embed", "blocks/wq", "blocks/wk",
                 "blocks/wv", "blocks/wo", "blocks/w_up", "blocks/w_down")


def derive_seed(seed: int, *parts) -> int:
    """A 63-bit generator seed from the run's seed and a name."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, device, *parts) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(derive_seed(seed, *parts))
    return g


def leaf_specs(cfg: dict) -> Dict[str, Tuple[tuple, Optional[float]]]:
    """{path: (shape, std)}; std None is a LayerNorm leaf (scale 1,
    bias 0).  The order is the draw order."""
    n, d, h, f = cfg["n_layers"], cfg["d_model"], cfg["n_heads"], cfg["d_ff"]
    dh = d // h
    resid = 0.02 / math.sqrt(2 * n)
    return {
        "blocks/ln1_scale": ((n, d), None), "blocks/ln1_bias": ((n, d), None),
        "blocks/wq": ((n, d, h, dh), 0.02), "blocks/wk": ((n, d, h, dh), 0.02),
        "blocks/wv": ((n, d, h, dh), 0.02), "blocks/wo": ((n, h, dh, d), resid),
        "blocks/ln2_scale": ((n, d), None), "blocks/ln2_bias": ((n, d), None),
        "blocks/w_up": ((n, d, f), 0.02), "blocks/w_down": ((n, f, d), resid),
        "tok_embed": ((cfg["vocab_size"], d), 0.02),
        "pos_embed": ((cfg["max_seq_len"], d), 0.01),
        "final_ln_scale": ((d,), None), "final_ln_bias": ((d,), None),
    }


def draw_leaf(cfg: dict, seed: int, path: str, device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Leaf `path` drawn in f32 on `device`, then cast to `dtype`."""
    shape, std = leaf_specs(cfg)[path]
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


def draw_params(cfg: dict, seed: int, device, *, matmul_dtype=torch.float32,
                keep: Optional[Callable] = None) -> dict:
    """The whole tree: matrix leaves and tables in `matmul_dtype` (the
    form a serving deployment loads: bf16), LayerNorm leaves f32.  With
    `keep`, each leaf goes to `keep(path, leaf)` as soon as it is drawn
    and the tree holds what it returns."""
    flat = {}
    for path in leaf_specs(cfg):
        dtype = matmul_dtype if path in MATMUL_LEAVES else torch.float32
        t = draw_leaf(cfg, seed, path, device, dtype)
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
