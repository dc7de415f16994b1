"""Topology-aware placement for the MPMD pipeline (port of the JAX-free
helpers of ray_tpu/parallel/mesh.py).

`stage_slice_plan`, `dcn_cut_edges` and `pipeline_placement_resources`
turn a gang -> slice plan into the per-gang resource dicts that
`PipelineTrainer(placement_plan=...)` merges into each gang's bundles.
`MeshConfig`, `create_mesh`, `create_two_level_mesh`, `slice_index_of`
and `shard_map_compat` build device meshes and wait for the
multi-device slice (ROADMAP A8).
"""

from __future__ import annotations

from typing import Sequence


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
