"""The port's parallelism layer (port of ray_tpu/parallel/): for now the
pieces that need no mesh of several ranks.

- `pipeline.py`: `chunk_assignment` (the MPMD pump's chunk ownership)
  and `stack_stage_params`;
- `mesh.py`: the topology-aware placement helpers of the MPMD pump
  (`stage_slice_plan`, `dcn_cut_edges`, `pipeline_placement_resources`).

The SPMD pipeline (`pipeline_apply`, `pipeline_loss_dryrun`), the meshes
(`MeshConfig`, `create_mesh`, `create_two_level_mesh`, `slice_index_of`)
and `sharding.py` wait for the multi-device slice (ROADMAP A8).
"""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    dcn_cut_edges,
    pipeline_placement_resources,
    stage_slice_plan,
)
from ray_tpu_torch.parallel.pipeline import (  # noqa: F401
    chunk_assignment,
    stack_stage_params,
)
