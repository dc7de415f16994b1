"""Device meshes for multi-dimensional parallelism, and the
topology-aware placement of the MPMD pipeline (port of
ray_tpu/parallel/mesh.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks
of the default process group, with the reference's six named axes in
its order:

  data    pure data parallelism (batch split, gradients summed)
  fsdp    data parallelism with sharded params and optimizer state
          (ZeRO-3: params gathered per layer, gradients reduce-scattered)
  expert  expert parallelism for MoE layers
  seq     sequence/context parallelism (ring attention over this axis)
  tensor  tensor (Megatron) parallelism within attention and MLP blocks
  stage   pipeline stage axis

A rank takes the place of a JAX device: `create_mesh` lays the ranks
out in row-major order, as `np.asarray(devices).reshape(shape)` lays
out the reference's devices, so the rank at a mesh position holds the
shard that the reference's device at that position holds.  `mesh_layout`
and `two_level_layout` give those layouts as arrays of ranks without a
process group.  `shard_map_compat` has no counterpart: the mesh path
runs each rank's local shards with explicit collectives
(`parallel.collectives`).

`stage_slice_plan`, `dcn_cut_edges` and `pipeline_placement_resources`
turn a gang -> slice plan into the per-gang resource dicts that
`PipelineTrainer(placement_plan=...)` merges into each gang's bundles.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device

AXES = ("data", "fsdp", "expert", "seq", "tensor", "stage")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each parallelism axis; -1 means "absorb the remaining
    ranks".  At most one axis may be -1, and the product of the resolved
    sizes must equal the rank count."""

    data: int = -1
    fsdp: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1
    stage: int = 1

    def resolve(self, n_devices: int) -> dict:
        sizes = {a: getattr(self, a) for a in AXES}
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes ({fixed})")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return sizes


def _ranks(devices: Optional[Sequence[int]]) -> list:
    if devices is not None:
        return [int(d) for d in devices]
    return list(range(torch.distributed.get_world_size()))


def mesh_layout(config: Optional[MeshConfig], devices: Sequence[int],
                axis_names: Sequence[str] = AXES) -> np.ndarray:
    """The ranks of `create_mesh` as an array of the mesh's shape."""
    sizes = (config or MeshConfig()).resolve(len(devices))
    return np.asarray(list(devices)).reshape(
        tuple(sizes[a] for a in axis_names))


def two_level_layout(ici: Optional[MeshConfig], dcn: Optional[MeshConfig],
                     n_slices: int, devices: Sequence[int],
                     axis_names: Sequence[str] = AXES) -> np.ndarray:
    """The ranks of `create_two_level_mesh` as an array of the mesh's
    shape: each axis is a DCN part (across slices, the high-order
    digits) times an ICI part (within a slice)."""
    devices = list(devices)
    if n_slices <= 0 or len(devices) % n_slices:
        raise ValueError(
            f"{len(devices)} devices not divisible into {n_slices} slices")
    per_slice = len(devices) // n_slices
    ici_sizes = (ici or MeshConfig()).resolve(per_slice)
    dcn_sizes = (dcn or MeshConfig(data=n_slices)).resolve(n_slices)
    for a in axis_names:
        if a in ("tensor", "seq", "expert") and dcn_sizes[a] > 1:
            raise ValueError(
                f"axis {a!r} must stay inside a slice (ICI): per-step "
                f"activation collectives over DCN would dominate the "
                f"step; shard it with the ici config instead")
    n_ax = len(axis_names)
    dev = np.asarray(devices).reshape(
        [dcn_sizes[a] for a in axis_names]
        + [ici_sizes[a] for a in axis_names])
    # Interleave (dcn_a, ici_a) per axis and merge: combined axis a has
    # the DCN part as the high-order digits.
    order = [i for pair in zip(range(n_ax), range(n_ax, 2 * n_ax))
             for i in pair]
    return dev.transpose(order).reshape(
        [dcn_sizes[a] * ici_sizes[a] for a in axis_names])


def _device_mesh(layout: np.ndarray, axis_names: Sequence[str],
                 device: DeviceLike):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(resolve_device(device).type, torch.as_tensor(layout),
                      mesh_dim_names=tuple(axis_names))


def create_mesh(config: Optional[MeshConfig] = None,
                devices: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = AXES, *,
                device: DeviceLike = None):
    """A DeviceMesh over the ranks `devices` (default: every rank of the
    default process group) per `config`, on `device`'s type (None ->
    CUDA).  Trailing (fastest-varying) axes get adjacent ranks, as the
    reference's trailing axes get ICI neighbours: `tensor` and `seq`
    come last in the default order.  Every rank of the group calls it."""
    return _device_mesh(mesh_layout(config, _ranks(devices), axis_names),
                        axis_names, device)


def create_two_level_mesh(
        ici: Optional[MeshConfig] = None,
        dcn: Optional[MeshConfig] = None,
        n_slices: int = 1,
        devices: Optional[Sequence[int]] = None,
        axis_names: Sequence[str] = AXES, *,
        device: DeviceLike = None):
    """Multi-slice mesh: every logical axis is the product of a DCN part
    (across slices) and an ICI part (within a slice), the DCN part
    slowest-varying, so walking any axis stays inside one slice until
    its ICI block is exhausted.  `tensor`, `seq` and `expert` over DCN
    are refused.  The ranks are grouped into `n_slices` equal contiguous
    blocks in order."""
    return _device_mesh(two_level_layout(ici, dcn, n_slices,
                                         _ranks(devices), axis_names),
                        axis_names, device)


def slice_index_of(mesh, n_slices: int) -> np.ndarray:
    """Each mesh position's slice id, for a DeviceMesh or an array of
    ranks: ranks fall into `n_slices` contiguous blocks (the grouping
    `create_two_level_mesh` used), as the reference's simulator groups
    device ids."""
    ranks = np.asarray(mesh.mesh.cpu() if hasattr(mesh, "mesh") else mesh)
    return ranks // (ranks.size // n_slices)


def single_device_mesh(device: DeviceLike = None):
    """A one-rank mesh with every axis of size 1 (on rank 0 of the
    default group)."""
    return create_mesh(MeshConfig(data=1), devices=[0], device=device)


def axis_sizes(mesh) -> dict:
    """{axis: size} of a DeviceMesh, or of anything with a `.shape`
    mapping (the reference's `mesh.shape`)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def mesh_axis_size(mesh, axis: str) -> int:
    return axis_sizes(mesh).get(axis, 1)


def stage_slice_plan(n_gangs: int, n_slices: int) -> list:
    """Gang -> slice assignment for topology-aware pipeline placement.

    Gangs (pipeline stage-actor groups, `train.pipeline_trainer`) are
    packed into contiguous blocks per slice, so chunk hand-offs between
    gangs inside one block stay inside a slice and only block boundaries
    cross between slices.  With the interleaved schedule (gang g owns
    chunks ``g, g+n_gangs, ...``) adjacent chunks are owned by adjacent
    gangs (mod n_gangs), so a contiguous gang block keeps adjacent
    chunks near by construction.

    Returns a list of length `n_gangs`: plan[g] = slice id.
    """
    if n_slices <= 0:
        raise ValueError(f"n_slices must be positive, got {n_slices}")
    if n_gangs % n_slices:
        raise ValueError(
            f"{n_gangs} gangs not divisible into {n_slices} slices — "
            f"unequal blocks would leave one slice's links underused")
    per = n_gangs // n_slices
    return [g // per for g in range(n_gangs)]


def dcn_cut_edges(plan: Sequence[int], n_chunks: int) -> list:
    """Chunk boundaries (c, c+1) whose hand-off crosses a slice boundary
    under a gang->slice `plan` with round-robin chunk ownership (chunk c
    is owned by gang ``c % len(plan)``).

    The placement quality oracle: ``len(plan)`` gangs in ``s`` slices
    force at least ``s - 1`` cuts per forward pass (plus interleave
    wraparounds), and a contiguous-block plan achieves that minimum for
    v=1."""
    n_gangs = len(plan)
    cuts = []
    for c in range(n_chunks - 1):
        if plan[c % n_gangs] != plan[(c + 1) % n_gangs]:
            cuts.append((c, c + 1))
    return cuts


def pipeline_placement_resources(plan: Sequence[int],
                                 prefix: str = "pp_slice_") -> list:
    """Per-gang custom-resource dicts realizing a `stage_slice_plan`:
    gang g's placement-group bundles demand ``{prefix}{plan[g]}: 1`` so
    its actors can only land on nodes advertising that slice resource
    (nodes declare e.g. ``resources={"pp_slice_0": 4}`` at start).
    Feed the result to ``PipelineTrainer(placement_plan=...)``."""
    return [{f"{prefix}{s}": 1} for s in plan]
