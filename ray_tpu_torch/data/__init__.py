"""The port's device feed (ray_tpu_torch/data/ingest.py)."""

from ray_tpu_torch.data.ingest import (  # noqa: F401
    BatchAssembler, BatchProducer, DeviceBatchIterator,
    batches_from_block_iter, iter_device_batches)
