"""The collectives of the port's mesh path, in one place.

Every collective of the mesh path (the train step's parameter gathers
and gradient reductions, the tensor-parallel activation sums, the
vocab-parallel cross-entropy) goes through the functions here:
`all_reduce`, `all_gather` and `reduce_scatter` on tensors
(`all_reduce_mean` for the replicas of a data-parallel learner), and their
autograd pairs (`all_gather_value` / `reduce_scatter_value`,
`all_reduce_value` / `all_reduce_grad`); `gather_replicated`, a gather
for a computation that every rank of the group repeats; and the ring's
rotation, `rotate` on tensors and `ppermute` with its autograd form,
and `tie`, which keeps a chain of rotations in every rank's backward.
A group of one rank is `None`, and every function is then the identity.

The rotation (each rank of a group sends to the rank `shift` places on
and receives from the rank `shift` places back, `lax.ppermute`'s ring)
takes one transport per backend, by rule: under NCCL
`batch_isend_irecv`, one send and one receive; under gloo
`all_to_all_single` with zero-size splits to every rank but the two
neighbours, because gloo's send and receive are for CPU tensors only
(`scripts/probe_collectives.py` found `batch_isend_irecv` on CUDA
tensors abort a rank, SIGABRT, torch 2.11, 4 ranks on one H100) while
its all-to-all takes CUDA tensors too.  The tensors of one rotation
travel as one buffer of bytes.

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
on CUDA tensors; each rank sets its card before it joins the group
(`launch._child`), and every rank of a group makes each rotation, its
first included, as NCCL's point-to-point calls require.  Nothing is
chosen by catching an error: a collective that fails fails the step.

`measure()` times every collective on the host clock, a device
synchronize on either side, so that a step's share of time in
collectives can be read; it is off unless asked for, since the
synchronizes cost time of their own.  A gather made with a `label`
(`all_gather_value(..., label="layer")`, the fsdp gathers of a block's
weights) is filed under its own ops, "layer_all_gather" and, for its
backward, "layer_reduce_scatter", so that they can be counted apart.
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

STATS = {"enabled": False, "calls": 0, "seconds": 0.0, "bytes": 0,
         "by_op": {}}


@contextlib.contextmanager
def measure():
    """Time every collective inside the block (host clock, a device
    synchronize before and after each); yields the STATS dict, reset on
    entry: calls, seconds, bytes (of the input tensors), and the same
    three per op in "by_op" ("all_reduce", "all_gather",
    "reduce_scatter", "rotate", and the labelled gathers' ops)."""
    STATS.update(enabled=True, calls=0, seconds=0.0, bytes=0, by_op={})
    try:
        yield STATS
    finally:
        STATS["enabled"] = False


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def _timed(t: torch.Tensor, op: str):
    if not STATS["enabled"]:
        yield
        return
    _sync(t)
    t0 = time.perf_counter()
    yield
    _sync(t)
    seconds, nbytes = time.perf_counter() - t0, t.numel() * t.element_size()
    mine = STATS["by_op"].setdefault(op, {"calls": 0, "seconds": 0.0,
                                          "bytes": 0})
    for stats in (STATS, mine):
        stats["calls"] += 1
        stats["seconds"] += seconds
        stats["bytes"] += nbytes


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of `t` over `group` ("sum" or "max")."""
    if group is None:
        return t
    with _timed(t, "all_reduce"):
        dist.all_reduce(t, op=_REDUCE_OPS[op], group=group)
    return t


def _all_reduce_flat(tensors: list, group, mean: bool) -> list:
    if group is None:
        return list(tensors)
    flat = all_reduce(torch.cat([t.detach().reshape(-1).float()
                                 for t in tensors]), group)
    if mean:
        flat /= dist.get_world_size(group)
    return [part.view(t.shape).to(t.dtype) for t, part in
            zip(tensors, flat.split([t.numel() for t in tensors]))]


def all_reduce_mean(tensors: list, group) -> list:
    """Each tensor's mean over `group` (data-parallel replicas' gradients
    and metrics), in one all-reduce of the tensors laid end to end; as
    they are when `group` is None."""
    return _all_reduce_flat(tensors, group, mean=True)


def all_reduce_sum(tensors: list, group) -> list:
    """Each tensor's sum over `group`, as `all_reduce_mean` (one
    all-reduce in f32; as they are when `group` is None)."""
    return _all_reduce_flat(tensors, group, mean=False)


def all_gather(t: torch.Tensor, group, dim: int = 0,
               op: str = "all_gather") -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order
    (filed under `op` by `measure()`)."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    with _timed(x, op):
        dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0,
                   op: str = "reduce_scatter") -> torch.Tensor:
    """The sum over the group of `t`, this rank's chunk of it along
    `dim` (group-rank order; filed under `op` by `measure()`)."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not split into {n}")
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    with _timed(x, op):
        dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim, label):
        ctx.group, ctx.dim, ctx.label = group, dim, label
        return all_gather(x, group, dim, _op(label, "all_gather"))

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.group, ctx.dim,
                               _op(ctx.label, "reduce_scatter")),
                None, None, None)


def _op(label: Optional[str], op: str) -> str:
    return op if label is None else f"{label}_{op}"


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


def rotate(tensors, group, shift: int = 1) -> list:
    """Each rank's `tensors` sent to the group rank `shift` places on;
    returns, in their place, those of the rank `shift` places back
    (group-rank order, wrapping round).  They travel as one buffer of
    bytes, by the backend's transport (see the module docstring)."""
    if group is None:
        return list(tensors)
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst, src = (me + shift) % n, (me - shift) % n
    flat = [t.contiguous().view(-1).view(torch.uint8) for t in tensors]
    send = flat[0] if len(flat) == 1 else torch.cat(flat)
    recv = torch.empty_like(send)
    with _timed(send, "rotate"):
        if dist.get_backend(group) == "nccl":
            for work in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, send,
                               dist.get_global_rank(group, dst), group),
                    dist.P2POp(dist.irecv, recv,
                               dist.get_global_rank(group, src), group)]):
                work.wait()
        else:
            out_splits, in_splits = [0] * n, [0] * n
            in_splits[dst] = out_splits[src] = send.numel()
            dist.all_to_all_single(recv, send, output_split_sizes=out_splits,
                                   input_split_sizes=in_splits, group=group)
    out = []
    for t, part in zip(tensors, recv.split([f.numel() for f in flat])):
        if part.storage_offset() % t.element_size():
            part = part.clone()
        out.append(part.view(t.dtype).view(t.shape))
    return out


class _Ppermute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return rotate([x], group, shift)[0]

    @staticmethod
    def backward(ctx, g):
        return rotate([g], ctx.group, -ctx.shift)[0], None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """`rotate` of one tensor with an autograd form: the gradient takes
    the reverse shift."""
    return x if group is None else _Ppermute.apply(x, group, shift)


class _Tie(torch.autograd.Function):

    @staticmethod
    def forward(ctx, out, chain):
        ctx.chain = (chain.shape, chain.dtype, chain.device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.chain
        return g, torch.zeros(shape, dtype=dtype, device=device)


def tie(out: torch.Tensor, chain: torch.Tensor) -> torch.Tensor:
    """`out` as it is, with `chain` (the end of a chain of `ppermute`s)
    tied to it: a zero gradient flows into the chain, so the backward
    rotates the chain's gradients on every rank as often as the forward
    rotated it, whatever the rank did with what it received (JAX's
    transpose of a scan rotates zeros alike).  A collective that runs
    on some ranks' backward and not on others' would desynchronise the
    group."""
    return _Tie.apply(out, chain)


class _GatherReplicated(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        return g.chunk(n, ctx.dim)[dist.get_rank(ctx.group)], None, None


def gather_replicated(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather along `dim` for a computation that every rank of
    `group` repeats on the whole (so each holds the whole gradient): the
    backward keeps this rank's chunk of the gradient, where
    `all_gather_value` would sum the group's."""
    return x if group is None else _GatherReplicated.apply(x, group, dim)


def all_gather_value(x: torch.Tensor, group, dim: int = 0,
                     label: Optional[str] = None) -> torch.Tensor:
    """All-gather along `dim`; the backward reduce-scatters the gradient
    (a sharded parameter gathered for use: ZeRO-3's pair).  With a
    `label`, `measure()` files the pair under "<label>_all_gather" and
    "<label>_reduce_scatter"."""
    return x if group is None else _AllGather.apply(x, group, dim, label)


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
