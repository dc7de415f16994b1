"""Pipeline helpers that need no mesh (port of the rank-free half of
ray_tpu/parallel/pipeline.py).

`chunk_assignment` is the round-robin chunk ownership of the MPMD pump
(`ray_tpu_torch.train.pipeline_trainer`), and `stack_stage_params` the
reference's per-stage stacking over tensors.  `pipeline_apply` and
`pipeline_loss_dryrun` run a `shard_map` over a stage axis of several
devices and wait for the multi-device slice (ROADMAP A8).
"""

from __future__ import annotations

from typing import Any

import torch


def chunk_assignment(n_chunks: int, n_gangs: int) -> list:
    """Round-robin chunk ownership for the interleaved (looping) MPMD
    schedule: gang g owns chunks ``g, g+n_gangs, ...`` — non-adjacent by
    construction, so every gang has work during warmup/drain and the
    pipeline bubble shrinks ~1/v for ``v = n_chunks // n_gangs`` chunks
    per gang.

    Returns a list of length `n_gangs`: assignment[g] = sorted chunk ids.
    """
    if n_gangs <= 0 or n_chunks % n_gangs:
        raise ValueError(
            f"{n_chunks} chunks not divisible across {n_gangs} gangs")
    return [list(range(g, n_chunks, n_gangs)) for g in range(n_gangs)]


def _stack(trees: list) -> Any:
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _stack([t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        seq = [_stack([t[i] for t in trees]) for i in range(len(t0))]
        return seq if isinstance(t0, list) else tuple(seq)
    return torch.stack([torch.as_tensor(t) for t in trees])


def stack_stage_params(per_stage_params: list) -> Any:
    """Stack a list of per-stage param pytrees along a new leading dim
    (one `torch.stack` per leaf)."""
    return _stack(list(per_stage_params))
