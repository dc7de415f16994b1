"""The collectives of the port's mesh path, in one place.

Every collective of the mesh path (the train step's parameter gathers
and gradient reductions, the tensor-parallel activation sums, the
vocab-parallel cross-entropy) goes through the functions here:
`all_reduce`, `all_gather` and `reduce_scatter` on tensors, and their
autograd pairs (`all_gather_value` / `reduce_scatter_value`,
`all_reduce_value` / `all_reduce_grad`).  A group of one rank is
`None`, and every function is then the identity.

Ranks that share one card cannot form an NCCL group, so they join a
gloo group and hand it CUDA tensors (gloo copies them through host
memory itself).  `scripts/probe_collectives.py` found, on torch 2.11
(CUDA 12.8) with 2 and 8 ranks on one H100, that gloo takes CUDA
tensors for every op used here: all_reduce (SUM and MAX, f32 and bf16),
all_gather_into_tensor and reduce_scatter_tensor (and all_to_all_single
and broadcast).  So no op is staged by hand.  What gloo's CUDA path does
not survive is a DTensor `redistribute` on a "cuda" DeviceMesh (the
process dies with SIGSEGV), so the mesh path never asks DTensor for a
collective: parameters are DTensors, but each rank computes on their
local shards and every collective is a call here, a change of layout
(`sharding.redistribute`) included.  With a card per
rank the group is NCCL (`launch.choose_backend`), which takes every op
on CUDA tensors.  Nothing is chosen by catching an error: a collective
that fails fails the step.

`measure()` times every collective on the host clock, a device
synchronize on either side, so that a step's share of time in
collectives can be read; it is off unless asked for, since the
synchronizes cost time of their own.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

STATS = {"enabled": False, "calls": 0, "seconds": 0.0, "bytes": 0}


@contextlib.contextmanager
def measure():
    """Time every collective inside the block (host clock, a device
    synchronize before and after each); yields the STATS dict, reset on
    entry: calls, seconds, bytes (of the input tensors)."""
    STATS.update(enabled=True, calls=0, seconds=0.0, bytes=0)
    try:
        yield STATS
    finally:
        STATS["enabled"] = False


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def _timed(t: torch.Tensor):
    if not STATS["enabled"]:
        yield
        return
    _sync(t)
    t0 = time.perf_counter()
    yield
    _sync(t)
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    STATS["bytes"] += t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of `t` over `group` ("sum" or "max")."""
    if group is None:
        return t
    with _timed(t):
        dist.all_reduce(t, op=_REDUCE_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    with _timed(x):
        dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over the group of `t`, this rank's chunk of it along
    `dim` (group-rank order)."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not split into {n}")
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    with _timed(x):
        dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _AllReduceValue(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


def all_gather_value(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather along `dim`; the backward reduce-scatters the gradient
    (a sharded parameter gathered for use: ZeRO-3's pair)."""
    return x if group is None else _AllGather.apply(x, group, dim)


def reduce_scatter_value(x: torch.Tensor, group,
                         dim: int = 0) -> torch.Tensor:
    """Reduce-scatter along `dim`; the backward all-gathers the gradient."""
    return x if group is None else _ReduceScatter.apply(x, group, dim)


def all_reduce_value(x: torch.Tensor, group) -> torch.Tensor:
    """Sum partial values over `group`; the gradient passes as is
    (Megatron's g: the exit of a row-parallel product)."""
    return x if group is None else _AllReduceValue.apply(x, group)


def all_reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over `group`
    (Megatron's f: a replicated input entering column-parallel
    products)."""
    return x if group is None else _AllReduceGrad.apply(x, group)


_groups: Dict[tuple, Optional[object]] = {}


def axis_group(mesh, axes: Tuple[str, ...]):
    """The process group of this rank over the mesh axes `axes` (their
    sizes above 1), or None when that is one rank.  Group ranks run in
    mesh order, the first axis major; the axes must be in the mesh's own
    order (a group's ranks are ascending).  Every rank of the mesh calls
    it with the same axes in the same order: a group is made once per
    mesh and axes, by all ranks together."""
    names = list(mesh.mesh_dim_names)
    shape = dict(zip(names, mesh.mesh.shape))
    axes = tuple(a for a in axes if shape.get(a, 1) > 1)
    if not axes:
        return None
    key = (mesh, axes)
    if key not in _groups:
        if len(axes) == 1:
            _groups[key] = mesh.get_group(axes[0])
        else:
            dims = [names.index(a) for a in axes]
            if dims != sorted(dims):
                raise ValueError(f"axes {axes} are not in the mesh's order "
                                 f"{tuple(names)}")
            layout = np.moveaxis(mesh.mesh.cpu().numpy(), dims,
                                 range(-len(dims), 0))
            me = dist.get_rank()
            for row in layout.reshape(-1, math.prod(shape[a] for a in axes)):
                group = dist.new_group([int(r) for r in row])
                if me in row:
                    _groups[key] = group
    return _groups[key]
