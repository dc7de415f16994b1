"""Pipeline parallelism over a mesh axis (port of
ray_tpu/parallel/pipeline.py): the GPipe-style SPMD pipeline
(`pipeline_apply`, `pipeline_loss_dryrun`), and what the MPMD pump
(`ray_tpu_torch.train.pipeline_trainer`) shares with it
(`chunk_assignment`, `stack_stage_params`).

The reference runs one `lax.scan` inside a `shard_map` over the `stage`
axis; here each rank of the mesh runs the same schedule in Python on
its own stage's params, and the activations hop from stage i to stage
i + 1 by `collectives.ppermute`.  Autograd gives the backward: the hop's
gradient takes the reverse shift, as the transpose of the reference's
`ppermute` does.

Layout, as in the reference: stage-local layer params are stacked on a
leading "stage" dim of every leaf; microbatches arrive on a leading dim
of size `n_micro` and are fed one per step.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import mesh_axis_size
from ray_tpu_torch.parallel.sharding import BATCH_AXES


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [_tree_map(fn, v) for v in tree]
        return seq if isinstance(tree, list) else tuple(seq)
    return fn(tree)


def _stages(stage_params, n: int) -> list:
    """The stack's n per-stage trees, one `unbind` per leaf (its backward
    stacks the stages' gradients into one tensor)."""
    parts = [t.unbind(0) for t in _leaves(stage_params)]
    out = []
    for s in range(n):
        it = iter([p[s] for p in parts])
        out.append(_tree_map(lambda _: next(it), stage_params))
    return out


def _sequential(stage_fn: Callable, stage_params, microbatches):
    n = _leaves(stage_params)[0].shape[0]
    stages = _stages(stage_params, n)
    outs = []
    for x in microbatches.unbind(0):
        for p in stages:
            x = stage_fn(p, x)
        outs.append(x)
    return torch.stack(outs)


def _own_rows(x):
    """This rank's rows of microbatches [n_micro, B, ...]: a plain
    tensor is already the rank's rows; a DTensor holds the global ones,
    whose B rows split over (data, fsdp) as the reference's `io_spec`
    splits them, evenly, as its `shard_map` requires: ValueError
    otherwise, before any collective."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    parts = math.prod(mesh_axis_size(x.device_mesh, a) for a in BATCH_AXES)
    if x.shape[1] % parts:
        raise ValueError(
            f"dim 1 of the microbatches {tuple(x.shape)} is not evenly "
            f"divisible by {parts}, the size of {BATCH_AXES}")
    return x.to_local()


def _own_stage(stage_params, stage: int, n_stages: int):
    lead = _leaves(stage_params)[0].shape[0]
    if lead not in (n_stages, 1):
        raise ValueError(f"stage params have a leading dim of {lead}: "
                         f"want {n_stages} (the whole stack) or 1 (this "
                         f"rank's stage)")
    i = stage if lead == n_stages else 0
    return _tree_map(lambda t: t[i], stage_params)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   mesh, stage_params: Any, microbatches: torch.Tensor,
                   axis: str = "stage") -> torch.Tensor:
    """Run `stage_fn(params_for_stage, x) -> y` (same shape in and out)
    as a pipeline over the mesh axis `axis`, on every rank of `mesh`.

    Args:
      stage_params: a tree whose leaves have a leading dim of n_stages
        (the whole stack: the rank takes its slice by its `axis`
        coordinate) or of 1 (the rank's own slice).  The gradient of a
        whole stack lands in this rank's slice only.
      microbatches: [n_micro, micro_batch, ...]; the micro batch is this
        rank's rows over (data, fsdp), as the reference's `io_spec`
        gives them (or a DTensor of the global microbatches, whose rows
        must split evenly: `_own_rows`).  Only stage 0 reads it, so its
        gradient lands on stage 0 alone.

    The schedule runs n_micro + n_stages - 1 steps: stage 0 takes
    microbatch min(t, n_micro - 1), every stage applies `stage_fn`, the
    activation moves from stage i to i + 1 (`collectives.ppermute`, +1
    over the stage group), and the last stage keeps microbatch
    t - (n_stages - 1) once that is at least 0.  A stage skips
    `stage_fn` on the steps where it holds no real microbatch
    (t - stage outside [0, n_micro)), so each rank calls it n_micro
    times; the rotation runs on every step all the same, with zeros in
    the bubble, so every rank joins every collective.  What the skipped
    calls would have computed never reaches a kept output, so the
    result and the gradients are the reference's.  Every step's
    rotation is tied into the next (`collectives.tie`), the first to
    the stage's params and the microbatches, and the last into the
    output, so every rank runs each rotation's backward, in the same
    order, whether the gradient is taken of the params, of the
    microbatches or of both.

    Returns [n_micro, micro_batch, ...] from the last stage, on every
    rank of the stage group: zero off the last stage, then summed over
    the group by `collectives.all_reduce_value`, whose backward passes
    the gradient through unchanged, so a loss that every stage computes
    gives the last stage the gradient of one loss (JAX's transpose of
    the reference's `psum`).

    With `mesh` None, or a stage axis of 1, it is the plain sequential
    loop: each microbatch through every stage of the stack in turn.
    """
    microbatches = _own_rows(microbatches)
    n_stages = 1 if mesh is None else mesh_axis_size(mesh, axis)
    if n_stages == 1:
        return _sequential(stage_fn, stage_params, microbatches)
    group = collectives.axis_group(mesh, (axis,))
    stage = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))[axis]
    params = _own_stage(stage_params, stage, n_stages)
    n_micro, last = microbatches.shape[0], n_stages - 1
    feeds = microbatches.unbind(0) if stage == 0 else None
    # The chain starts tied to the rank's params and microbatches, so a
    # gradient taken with respect to either (`torch.autograd.grad` runs
    # only the nodes on a path to its inputs) still runs every rotation.
    state = torch.zeros_like(microbatches[0])
    for leaf in [microbatches] + _leaves(params):
        state = collectives.tie(state, leaf)
    kept = []
    for t in range(n_micro + n_stages - 1):
        x = feeds[min(t, n_micro - 1)] if stage == 0 else state
        y = stage_fn(params, x) if 0 <= t - stage < n_micro \
            else torch.zeros_like(x)
        if stage == last and t >= last:
            kept.append(y)
        state = collectives.ppermute(collectives.tie(y, state), group, 1)
    outputs = torch.stack(kept) if stage == last \
        else torch.zeros_like(microbatches)
    return collectives.all_reduce_value(collectives.tie(outputs, state),
                                        group)


def pipeline_loss_dryrun(stage_fn: Callable, loss_fn: Callable, mesh,
                         stage_params: Any, microbatches: torch.Tensor,
                         targets: torch.Tensor,
                         axis: str = "stage") -> torch.Tensor:
    """Mean microbatch loss of the single-program GPipe schedule: the
    value the MPMD trainer (train/pipeline_trainer.py) must match on the
    same schedule.

    `loss_fn(y, target) -> scalar` is applied per microbatch to the
    pipeline's outputs; `targets` has the same [n_micro, ...] layout as
    `microbatches` (this rank's rows).  Under a mesh whose (data, fsdp)
    ranks split the rows, the outputs and targets are gathered over
    them first, so every rank computes the loss of the global
    microbatches, as the reference's GSPMD program does; the gather's
    backward keeps this rank's rows of the gradient.  `microbatches` and
    `targets` are the rank's rows or DTensors, as in `pipeline_apply`."""
    microbatches, targets = _own_rows(microbatches), _own_rows(targets)
    outputs = pipeline_apply(stage_fn, mesh, stage_params, microbatches,
                             axis=axis)
    rows = None if mesh is None else collectives.axis_group(mesh,
                                                            BATCH_AXES)
    if rows is not None:
        outputs = collectives.gather_replicated(outputs, rows, 1)
        targets = collectives.all_gather(targets, rows, 1)
    return torch.stack([loss_fn(y, t) for y, t in
                        zip(outputs.unbind(0), targets.unbind(0))]).mean()


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
