"""The port's device feed (ray_tpu_torch/data/ingest.py) on the CPU:
batches equal to the numpy batches, and to the reference's assembly of
the same rows; the bounds on queued and in-flight batches; a producer
error reaching the consumer; close() stopping the producer thread; a
duck-typed shard; the Observer's metering under the reference's names.
The CUDA path (pinned staging, side stream, events) runs on the card
in chip_smoke.py's train_fabric phase."""

import time

import numpy as np
import pytest
import torch

from ray_tpu.data import block as blk
from ray_tpu.data import ingest as jingest
from ray_tpu_torch.data import ingest
from ray_tpu_torch.util.observe import Observer

torch.set_num_threads(1)

# Deliberately misaligned with the batch size: batches span blocks.
SIZES = [(0, 7), (7, 13), (20, 1), (21, 29), (50, 50)]


def _blocks():
    rng = np.random.default_rng(0)
    return [{"id": np.arange(lo, lo + n),
             "x": rng.standard_normal((n, 3)).astype(np.float32),
             "tokens": rng.integers(0, 512, (n, 8)).astype(np.int32)}
            for lo, n in SIZES]


def _as_numpy(batch):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in batch.items()}


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _as_numpy(g), _as_numpy(w)
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("drop_last", [False, True])
def test_device_batches_equal_the_numpy_batches(drop_last):
    sync = list(ingest.batches_from_block_iter(_blocks(), 16, drop_last))
    assert [len(b["id"]) for b in sync] == [16] * 6 + ([] if drop_last
                                                       else [4])
    # The reference assembles the same rows from Arrow blocks.
    ref = list(jingest.batches_from_block_iter(
        [blk.batch_to_block(b) for b in _blocks()], 16, drop_last=drop_last))
    _assert_batches_equal(sync, ref)
    dev = list(ingest.iter_device_batches(_blocks(), device="cpu",
                                          batch_size=16,
                                          drop_last=drop_last))
    assert all(isinstance(v, torch.Tensor) for b in dev for v in b.values())
    _assert_batches_equal(dev, sync)


def test_assembler_buffers_only_the_tail():
    asm = ingest.BatchAssembler(10)
    for lo in range(0, 90, 30):
        asm.add_block({"id": np.arange(lo, lo + 30)})
        while asm.next_batch() is not None:
            pass
        assert asm.buffered_rows < 10
        assert len(asm._blocks) <= 1


def test_queue_and_device_buffers_stay_bounded():
    blocks = [{"id": np.arange(lo, lo + 100)} for lo in range(0, 800, 100)]
    dev = ingest.iter_device_batches(blocks, device="cpu", batch_size=50,
                                     queue_depth=3, device_buffers=2)
    ids = []
    for batch in dev:
        ids.extend(batch["id"].tolist())
        time.sleep(0.01)      # the consumer is the bottleneck
    stats = dev.stats()
    assert ids == list(range(800))
    assert stats["batches"] == 16
    assert stats["max_queue_depth"] <= 3
    assert stats["max_device_inflight"] <= 2
    assert stats["device_buffers"] == 2
    assert stats["producer_wait_s"] > 0


def test_producer_error_reaches_the_consumer():
    def blocks():
        yield {"id": np.arange(10)}
        raise ValueError("bad block")

    # One device buffer: each batch is handed out before the next is read.
    dev = ingest.iter_device_batches(blocks(), device="cpu", batch_size=4,
                                     device_buffers=1)
    got = []
    with pytest.raises(ValueError, match="bad block"):
        for batch in dev:
            got.append(batch["id"].tolist())
    assert got == [[0, 1, 2, 3], [4, 5, 6, 7]]   # the full batches before


def test_close_stops_the_producer_thread():
    def endless():
        lo = 0
        while True:
            yield {"id": np.arange(lo, lo + 8)}
            lo += 8

    dev = ingest.iter_device_batches(endless(), device="cpu", batch_size=4)
    it = iter(dev)
    assert next(it)["id"].tolist() == [0, 1, 2, 3]
    dev.close()
    thread = dev._producer._thread
    thread.join(5)
    assert not thread.is_alive()


class _Shard:
    """Anything with iter_batches(batch_format="numpy"), as the
    reference's dataset shards are."""

    def __init__(self, blocks):
        self.blocks = blocks
        self.calls = []

    def iter_batches(self, *, batch_size, batch_format, drop_last):
        self.calls.append((batch_size, batch_format, drop_last))
        return ingest.batches_from_block_iter(self.blocks, batch_size,
                                              drop_last)


def test_a_duck_typed_shard():
    shard = _Shard(_blocks())
    dev = list(ingest.iter_device_batches(shard, device="cpu",
                                          batch_size=32, drop_last=True))
    assert shard.calls == [(32, "numpy", True)]
    _assert_batches_equal(dev, list(ingest.batches_from_block_iter(
        _blocks(), 32, drop_last=True)))


class _Meter(Observer):
    def __init__(self):
        self.counts, self.gauges, self.samples, self.spans = {}, {}, {}, []

    def inc(self, name, n=1.0):
        self.counts[name] = self.counts.get(name, 0) + n

    def set(self, name, value):
        self.gauges[name] = value

    def observe(self, name, value):
        self.samples.setdefault(name, []).append(value)

    def begin(self, plane, kind, **fields):
        return (plane, kind)

    def end(self, token, **fields):
        self.spans.append(token)


def test_metering_uses_the_reference_names():
    meter = _Meter()
    list(ingest.iter_device_batches(_blocks(), device="cpu", batch_size=16,
                                    observer=meter))
    assert meter.counts["ingest_batches"] == 7
    assert "ingest_consumer_wait_seconds" in meter.counts
    assert "ingest_queue_depth" in meter.gauges
    assert len(meter.samples["ingest_fetch_s"]) == len(SIZES)
    assert len(meter.samples["ingest_assemble_s"]) == len(SIZES)
    assert meter.spans.count(("ingest", "h2d")) == 7
    assert meter.spans.count(("ingest", "ingest_wait")) == 8  # + the end


def test_the_feed_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ingest.iter_device_batches(_blocks(), batch_size=16)
