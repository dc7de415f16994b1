"""Sharded, asynchronous checkpoints of trees of torch tensors (port of
ray_tpu/checkpoint/, single device), in the reference's on-disk format:

    from ray_tpu_torch import checkpoint as ckpt

    mgr = ckpt.CheckpointManager(root, keep_last_k=3)
    handle = mgr.save(step, tree)          # host copy now, write on a thread
    mgr.wait_until_finished()              # explicit barrier when needed
    tree = mgr.restore_latest(device="cuda")
"""

from ray_tpu_torch.checkpoint.async_writer import (  # noqa: F401
    AsyncCheckpointer, CheckpointWriteError, SaveHandle)
from ray_tpu_torch.checkpoint.manager import CheckpointManager  # noqa: F401
from ray_tpu_torch.checkpoint.manifest import (  # noqa: F401
    COMMIT_FILE, MANIFEST_FILE)
from ray_tpu_torch.checkpoint.sharded import (  # noqa: F401
    checkpoint_metadata, is_committed, restore_sharded, save_sharded)
