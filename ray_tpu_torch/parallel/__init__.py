"""The port's parallelism layer (port of ray_tpu/parallel/): meshes,
sharding rules, the collectives of the mesh path, the rank launcher and
the pipeline helpers.

- `mesh.py`: `MeshConfig`, `create_mesh` and `create_two_level_mesh`
  (a `DeviceMesh` over the ranks, in the reference's axis and device
  order), `slice_index_of`, `single_device_mesh`, `mesh_axis_size`,
  and the topology-aware placement helpers of the MPMD pump
  (`stage_slice_plan`, `dcn_cut_edges`, `pipeline_placement_resources`);
- `sharding.py`: the logical rules (`DEFAULT_RULES`, `logical_to_spec`)
  and their placements as DTensors (`named_sharding`, `tree_shardings`,
  `shard_opt_state`, `shard_batch`, `global_batch`, ...);
- `collectives.py`: every collective of the mesh path;
- `launch.py`: `run_ranks`, the ranks of a mesh as spawned processes;
- `pipeline.py`: `chunk_assignment` (the MPMD pump's chunk ownership)
  and `stack_stage_params`.

The SPMD pipeline (`pipeline_apply`, `pipeline_loss_dryrun`) waits for
its item of ROADMAP A8.
"""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES,
    MeshConfig,
    create_mesh,
    create_two_level_mesh,
    dcn_cut_edges,
    mesh_axis_size,
    mesh_layout,
    pipeline_placement_resources,
    single_device_mesh,
    slice_index_of,
    stage_slice_plan,
    two_level_layout,
)
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES,
    NamedSharding,
    batch_shardings,
    global_batch,
    logical_to_spec,
    named_sharding,
    shard_batch,
    shard_opt_state,
    tree_shardings,
    with_logical_constraint,
)
from ray_tpu_torch.parallel.pipeline import (  # noqa: F401
    chunk_assignment,
    stack_stage_params,
)
