"""Logical-axis sharding rules: annotate tensors by meaning, not mesh
axis (port of ray_tpu/parallel/sharding.py).

Parameters and activations carry *logical* axis names ("embed", "mlp",
"heads", "batch", "length", ...).  A rule table maps logical -> mesh
axes; changing the parallelism strategy is a rule-table swap, never a
model edit.

A spec is the reference's PartitionSpec as a tuple: one entry per
tensor dim, each None, a mesh axis, or a tuple of mesh axes (the first
the major one), trailing Nones dropped.  A tensor placed by a spec is a
DTensor whose local tensor is exactly the slice that JAX's
`addressable_shards` gives the device at the same mesh position
(`local_index`).  Its DTensor placements (`placements`) say the same
thing: `Shard(d)` per mesh axis of dim d, or `_StridedShard` where an
axis tuple runs against the mesh's order (the vocab dim's
("tensor", "fsdp")).

The train step computes on the local tensors with explicit collectives
(`parallel.collectives`), and its optimizer steps the local tensors in
place; DTensor here holds the layout and gives the global view
(`full_tensor()` on the CPU).  A change of layout (`redistribute`,
`with_logical_constraint`) goes through the same collectives.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Tuple, Union

import torch

from ray_tpu_torch.parallel.mesh import axis_sizes

LogicalSpec = Tuple[Optional[str], ...]

# The mesh axes a batch's rows split over (the "batch" rule below, and
# the reference pipeline's `io_spec`); every other axis holds replicas.
BATCH_AXES = ("data", "fsdp")

# Default rule table: logical axis -> mesh axis (or tuple of mesh axes).
# Covers dense transformer + MoE.  "embed" maps to fsdp so that ZeRO-3
# style weight sharding engages when the fsdp axis is > 1.
DEFAULT_RULES: Mapping[str, Union[str, Tuple[str, ...], None]] = {
    "batch": BATCH_AXES,         # global batch split over both DP axes
    "length": "seq",             # sequence dim: context parallelism
    "embed": "fsdp",             # param embed dim: FSDP shard
    "act_embed": None,           # activation embed dim: full
    "mlp": "tensor",             # ffn hidden: megatron column/row split
    "heads": "tensor",           # attention heads: megatron split
    "kv_heads": "tensor",        # GQA key/value head groups (llama)
    "kv": None,                  # per-head dim: never sharded
    # The vocab dim carries both the tensor and the fsdp shards of the
    # embedding table (tensor major), so the table's embed dim stays
    # whole and a tensor rank's vocab slice is its fsdp group's pieces
    # side by side.
    "vocab": ("tensor", "fsdp"),  # embedding/logits vocab dim
    "experts": "expert",         # MoE expert dim
    "expert_mlp": "tensor",      # ffn hidden inside an expert
    "layers": None,              # stacked layer dim
    "stage": "stage",            # pipeline stage dim
}


def logical_to_spec(logical: LogicalSpec,
                    rules: Optional[Mapping] = None,
                    mesh=None) -> tuple:
    """Translate a logical spec like ("batch", "length", "embed") to a
    spec tuple using `rules`.  Mesh axes of size 1 (or absent) are
    dropped so the same rules work on any mesh shape, and a mesh axis
    shards at most one dim: the first logical axis that maps to it wins."""
    rules = DEFAULT_RULES if rules is None else rules
    sizes = axis_sizes(mesh) if mesh is not None else None
    out = []
    used: set = set()
    for name in logical:
        mapped = rules.get(name) if name is not None else None
        if mapped is None:
            out.append(None)
            continue
        axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        if sizes is not None:
            axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: tuple) -> set:
    """The mesh axes that shard some dim under `spec`."""
    return {a for entry in spec for a in _entry_axes(entry)}


def placements(mesh, spec: tuple) -> list:
    """One DTensor placement per mesh dim for a tensor laid out by
    `spec`: Replicate() where no dim takes the axis, Shard(d) where dim
    d does, and _StridedShard(d, split_factor) where dim d's axis tuple
    puts a later mesh axis before this one (the later one's size is the
    split factor)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    names = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = []
    for i, axis in enumerate(names):
        place = Replicate()
        for d, entry in enumerate(spec):
            axes = [a for a in _entry_axes(entry) if sizes.get(a, 1) > 1]
            if axis not in axes:
                continue
            split = math.prod(sizes[a] for a in axes[:axes.index(axis)]
                              if names.index(a) > i)
            place = Shard(d) if split == 1 else _StridedShard(
                d, split_factor=split)
        out.append(place)
    return out


def _position(entry, mesh, coordinate=None) -> Tuple[int, int]:
    """(index, parts): the coordinates of the axes of a spec entry at
    `coordinate` (default this rank's) read as one number, the first
    axis major, and the product of their sizes."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()
                     if coordinate is None else coordinate))
    idx, parts = 0, 1
    for a in _entry_axes(entry):
        idx = idx * sizes.get(a, 1) + coord.get(a, 0)
        parts *= sizes.get(a, 1)
    return idx, parts


def local_index(shape, spec: tuple, mesh, coordinate=None) -> tuple:
    """The slices of a tensor of global `shape` held at `coordinate` (a
    mesh coordinate; default this rank's) under `spec`: for each dim,
    its axes' coordinates read as one number, the first axis major, pick
    an even chunk.  An uneven split raises ValueError: this is the
    placement of parameters, optimizer moments and `shard_batch`, where
    the reference's `device_put` refuses an uneven split too.  The train
    steps take the rows of an unplaced global batch by `row_split`,
    which pads them as GSPMD does."""
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        idx, parts = _position(entry, mesh, coordinate)
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"evenly into {parts} ({entry})")
        chunk = n // parts
        out.append(slice(idx * chunk, (idx + 1) * chunk))
    return tuple(out)


def row_split(n: int, mesh, coordinate=None) -> Tuple[slice, int]:
    """GSPMD's split of a global batch of `n` rows over the row ranks
    (BATCH_AXES, read data-major as in `local_index`): each of the
    `parts` ranks holds chunk = ceil(n / parts) rows, rank i the real
    rows [i * chunk, min(n, (i + 1) * chunk)) and pad rows after them,
    so a rank may hold none.  Returns (the slice of its real rows,
    chunk); an even split is `local_index`'s."""
    idx, parts = _position(BATCH_AXES, mesh, coordinate)
    chunk = -(-n // parts)
    lo = min(n, idx * chunk)
    return slice(lo, min(n, lo + chunk)), chunk


def pad_rows(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """`x` with zero rows appended along dim 0 up to `chunk` rows."""
    if x.shape[0] == chunk:
        return x
    return torch.cat([x, x.new_zeros((chunk - x.shape[0],)
                                     + tuple(x.shape[1:]))])


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the reference's jax.sharding.NamedSharding)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)

    def shard(self, full, device=None):
        """This rank's slice of the global tensor `full` (a tensor or an
        array, the same on every rank) as a DTensor on `device` (default:
        the mesh's device type, current card)."""
        full = torch.as_tensor(full)
        return self.wrap(full[local_index(full.shape, self.spec, self.mesh)],
                         tuple(full.shape), device)

    def wrap(self, local, shape: tuple, device=None):
        """This rank's `local` slice of a global tensor of `shape` as a
        DTensor on `device` (default: the mesh's card)."""
        from torch.distributed.tensor import DTensor

        local = local.to(device or mesh_device(self.mesh)).contiguous()
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=shape,
                                  stride=_contiguous_stride(shape))


def mesh_device(mesh) -> torch.device:
    """The device of this rank's shards on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def named_sharding(mesh, logical: LogicalSpec,
                   rules: Optional[Mapping] = None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(logical, rules, mesh))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def tree_map(fn, tree, *rest, is_leaf=None):
    """`fn` over the leaves of nested dicts, lists and tuples (`rest`
    congruent with `tree`)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        items = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                 for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)


def tree_shardings(mesh, logical_tree: Any,
                   rules: Optional[Mapping] = None) -> Any:
    """Map a tree of logical specs to a tree of NamedShardings."""
    return tree_map(lambda spec: named_sharding(mesh, spec, rules),
                    logical_tree, is_leaf=_is_spec)


def _gather_full(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The global tensor from this rank's `local` slice under `spec`:
    each sharded dim gathered over its axes, the minor axis first (its
    group's pieces are contiguous inside the major axis's)."""
    from ray_tpu_torch.parallel import collectives

    for d, entry in enumerate(spec):
        for axis in reversed(_entry_axes(entry)):
            local = collectives.all_gather(
                local, collectives.axis_group(mesh, (axis,)), d)
    return local


class _Reshard(torch.autograd.Function):
    """A local slice under spec `src` -> the local slice under `dst`, by
    the port's collectives (gathered whole, then sliced); the backward
    is the same move from `dst` back to `src`."""

    @staticmethod
    def forward(ctx, local, mesh, shape, src, dst):
        ctx.mesh, ctx.shape, ctx.src, ctx.dst = mesh, shape, src, dst
        full = _gather_full(local, src, mesh)
        return full[local_index(shape, dst, mesh)].contiguous()

    @staticmethod
    def backward(ctx, g):
        full = _gather_full(g.contiguous(), ctx.dst, ctx.mesh)
        return (full[local_index(ctx.shape, ctx.src, ctx.mesh)].contiguous(),
                None, None, None, None)


def redistribute(x, spec: tuple, mesh=None):
    """A DTensor laid out by `spec` on its mesh (`mesh`, when given, must
    be it).  The move goes through `parallel.collectives` (the axes of
    each sharded dim all-gathered, then this rank's slice of `spec`
    taken), never through DTensor's own `redistribute`, which kills the
    process on a CUDA mesh over gloo; it carries gradients.  A DTensor
    already laid out so is returned as it is."""
    from torch.distributed.tensor import DTensor

    if mesh is not None and x.device_mesh != mesh:
        raise ValueError("redistribute: the DTensor lies on another mesh")
    mesh = x.device_mesh
    src = spec_of(x)
    if src == tuple(spec):
        return x
    shape = tuple(x.shape)
    local = _Reshard.apply(x.to_local(), mesh, shape, src, tuple(spec))
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def with_logical_constraint(x, logical: LogicalSpec,
                            rules: Optional[Mapping] = None, mesh=None):
    """Lay a DTensor out by its logical spec (`redistribute`, through the
    port's collectives).  Without a mesh, or on a mesh whose axes are
    all 1, a no-op.  The train step does not call it: its local shards
    are laid out so by construction."""
    if mesh is None or all(s <= 1 for s in axis_sizes(mesh).values()):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError("with_logical_constraint under a mesh takes a "
                        "DTensor")
    return redistribute(x, logical_to_spec(logical, rules, mesh), mesh)


def _structure(node):
    if isinstance(node, dict):
        return {k: _structure(v) for k, v in node.items()}
    return None


def shard_opt_state(opt_state: Any, params: Any, param_shardings: Any,
                    mesh) -> Any:
    """Place an optimizer state tree on the mesh: any subtree congruent
    with the params tree (Adam's mu and nu, momentum, ...) takes the
    param shardings leaf for leaf; every other tensor or array leaf
    (step counts, scalars) is replicated; anything else is kept."""
    pstruct = _structure(params)
    replicated = NamedSharding(mesh, ())

    def place(node):
        if isinstance(node, dict) and _structure(node) == pstruct:
            return tree_map(lambda x, s: s.shard(x), node, param_shardings)
        if isinstance(node, (dict, list, tuple)):
            if isinstance(node, dict):
                return {k: place(v) for k, v in node.items()}
            items = [place(v) for v in node]
            return type(node)(*items) if hasattr(node, "_fields") \
                else type(node)(items)
        if hasattr(node, "shape"):          # a tensor, array or numpy scalar
            return replicated.shard(node)
        return node

    return place(opt_state)


def spec_of(x) -> tuple:
    """The spec tuple of a DTensor's placements (`placements`'s
    inverse): each dim's mesh axes, major first, where a _StridedShard
    axis sits after the later mesh axes whose sizes make its split
    factor."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    names = list(x.device_mesh.mesh_dim_names)
    sizes = axis_sizes(x.device_mesh)
    entries: dict = {}
    strided = []
    for i, place in enumerate(x.placements):
        if isinstance(place, _StridedShard):
            strided.append((place.dim, names[i], place.split_factor))
        elif isinstance(place, Shard):
            entries.setdefault(place.dim, []).append(names[i])
    for d, axis, split in strided:
        axes = entries.setdefault(d, [])
        pos, acc = 0, 1
        while acc < split:
            acc *= sizes[axes[pos]]
            pos += 1
        axes.insert(pos, axis)
    out = []
    for d in range(x.dim()):
        axes = entries.get(d, [])
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else tuple(axes))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _batch_logical(x) -> LogicalSpec:
    if x.ndim >= 2:
        return ("batch", "length") + (None,) * (x.ndim - 2)
    return ("batch",) + (None,) * (x.ndim - 1)


def batch_shardings(mesh, batch: Any,
                    rules: Optional[Mapping] = None) -> Any:
    """Per-leaf NamedShardings for a batch tree with the ("batch",
    "length") layout: the placement half of `shard_batch`.  The device
    feed resolves a bare mesh through this."""
    return tree_map(lambda x: named_sharding(mesh, _batch_logical(x), rules),
                    batch)


def shard_batch(mesh, batch: Any, rules: Optional[Mapping] = None) -> Any:
    """Each leaf of a global batch tree (the same on every rank) as a
    DTensor holding this rank's rows: the batch dim splits over the data
    axes, and ranks that differ only in other axes hold the same rows."""
    return tree_map(lambda x, s: s.shard(x), batch,
                    batch_shardings(mesh, batch, rules))


def global_batch(mesh, local_batch: Any,
                 rules: Optional[Mapping] = None) -> Any:
    """Multi-controller batch assembly: each rank passes its LOCAL rows
    (the rows of its position along the data axes, and its length slice
    along seq; ranks that differ only in other axes pass the same
    rows), and each leaf becomes a DTensor of the global batch, each of
    whose dims is the local one times the number of its shards."""
    from torch.distributed.tensor import DTensor

    def put(x, sharding):
        x = torch.as_tensor(x).to(mesh_device(mesh))
        sizes = axis_sizes(mesh)
        spec = tuple(sharding.spec) + (None,) * (x.dim() - len(
            sharding.spec))
        shape = tuple(n * math.prod(sizes.get(a, 1) for a in
                                    _entry_axes(entry))
                      for n, entry in zip(x.shape, spec))
        return DTensor.from_local(x.contiguous(), mesh, sharding.placements,
                                  run_check=False, shape=shape,
                                  stride=_contiguous_stride(shape))
    return tree_map(put, local_batch, batch_shardings(mesh, local_batch,
                                                      rules))


def local_shard(x, mesh=None, spec: tuple = ()) -> torch.Tensor:
    """The local tensor of a DTensor; a plain tensor is taken as global
    and sliced by `spec` on `mesh` (as a jitted reference function
    reshards an unplaced argument)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.to_local()
    x = torch.as_tensor(x)
    if mesh is None:
        return x
    return x[local_index(x.shape, spec, mesh)]
