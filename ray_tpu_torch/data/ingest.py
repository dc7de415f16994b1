"""The device feed (port of ray_tpu/data/ingest.py's batch assembly,
background producer and device iterator).

Three stages that a naive loop serialises on the training thread
overlap here, as in the reference:

  * `BatchAssembler` — fixed-size batches from a stream of blocks with a
    row cursor: each block is consumed once and each batch costs
    O(batch rows).  A block is a dict of numpy columns of equal length
    (the reference's are Arrow tables; its `iter_blocks_from_refs`
    needs the runtime and stays with the caller).
  * `BatchProducer` — a background thread pulls blocks, assembles
    batches and, for a CUDA feed, copies each into a pinned staging
    buffer, handing them over through a bounded queue.  Producer-starved
    and consumer-starved seconds are metered.
  * `DeviceBatchIterator` — keeps up to `buffers` batches in flight on
    the device: each staged batch is copied to the card on a side CUDA
    stream (`non_blocking`), an event records the copy's end, the
    consumer's stream waits on that event when the batch is handed out,
    and every tensor is marked as used by the consumer's stream.  A
    staging buffer is written again only after its copy's event has
    completed.  A CPU device takes plain tensors over the numpy batch.

Batches are numerically identical to the numpy batches.  Metering goes
to the caller's `Observer` under the reference's names: counters
`ingest_batches`, `ingest_producer_wait_seconds`,
`ingest_consumer_wait_seconds`; gauge `ingest_queue_depth`; histograms
`ingest_fetch_s`, `ingest_assemble_s`; spans ("ingest", "ingest_wait")
and ("ingest", "h2d"); event ("ingest", "producer_starved").
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.util.observe import NOOP, Observer

# The reference's defaults (ingest_queue_depth, ingest_device_buffers).
QUEUE_DEPTH = 2
DEVICE_BUFFERS = 2

Block = Dict[str, np.ndarray]


def _rows(block: Block) -> int:
    return len(next(iter(block.values()))) if block else 0


class BatchAssembler:
    """Assemble fixed-size batches from a stream of blocks (dicts of
    numpy columns).  Blocks enter once via `add_block`; a row cursor
    walks them so each emitted batch slices only the rows it contains,
    and concatenates only when it spans blocks."""

    def __init__(self, batch_size: int):
        self._batch_size = max(1, int(batch_size))
        self._blocks: deque = deque()
        self._cursor = 0          # row offset into _blocks[0]
        self._rows = 0            # buffered rows at/after the cursor

    @property
    def buffered_rows(self) -> int:
        return self._rows

    def add_block(self, block: Block) -> None:
        n = _rows(block)
        if n:
            self._blocks.append(block)
            self._rows += n

    def _take(self, n: int) -> Block:
        pieces = []
        need = n
        while need:
            head = self._blocks[0]
            rows = _rows(head)
            take = min(rows - self._cursor, need)
            pieces.append({k: v[self._cursor:self._cursor + take]
                           for k, v in head.items()})
            self._cursor += take
            need -= take
            self._rows -= take
            if self._cursor == rows:
                self._blocks.popleft()
                self._cursor = 0
        if len(pieces) == 1:
            return pieces[0]
        return {k: np.concatenate([p[k] for p in pieces])
                for k in pieces[0]}

    def next_batch(self) -> Optional[Block]:
        """One full batch, or None until enough rows are buffered."""
        if self._rows < self._batch_size:
            return None
        return self._take(self._batch_size)

    def flush(self) -> Optional[Block]:
        """The final partial batch (or None if nothing is buffered)."""
        if not self._rows:
            return None
        return self._take(self._rows)


def batches_from_block_iter(blocks: Iterable[Block], batch_size: int,
                            drop_last: bool = False,
                            observer: Optional[Observer] = None
                            ) -> Iterator[Block]:
    """Synchronous assembly over a block stream.  Per-block fetch
    (pulling the next block out of the iterator) and assemble latencies
    feed the two ingest histograms."""
    obs = observer or NOOP
    asm = BatchAssembler(batch_size)
    it = iter(blocks)
    while True:
        t0 = time.perf_counter()
        try:
            b = next(it)
        except StopIteration:
            break
        obs.observe("ingest_fetch_s", time.perf_counter() - t0)
        t1 = time.perf_counter()
        ready = []
        asm.add_block(b)
        while True:
            batch = asm.next_batch()
            if batch is None:
                break
            ready.append(batch)
        obs.observe("ingest_assemble_s", time.perf_counter() - t1)
        yield from ready
    if not drop_last:
        tail = asm.flush()
        if tail is not None:
            yield tail


_DONE = object()


class BatchProducer:
    """Pulls blocks and assembles batches on a background thread; the
    training thread only drains a bounded queue.  `stage`, when given,
    runs on the producer thread on each batch before the handoff (the
    device iterator's pinned copy).  `stats()` gives `producer_wait_s`
    (blocked on a full queue: the consumer is the bottleneck) and
    `consumer_wait_s` (blocked on an empty queue: the producer is)."""

    def __init__(self, block_iter: Iterable[Block], batch_size: int,
                 drop_last: bool = False, queue_depth: Optional[int] = None,
                 stage: Optional[Callable[[Block], Any]] = None,
                 observer: Optional[Observer] = None):
        self._depth = max(1, int(queue_depth if queue_depth is not None
                                 else QUEUE_DEPTH))
        self._q: queue.Queue = queue.Queue(maxsize=self._depth)
        self._blocks = block_iter
        self._batch_size = batch_size
        self._drop_last = drop_last
        self._stage = stage
        self._obs = observer or NOOP
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._stats = {"batches": 0, "producer_wait_s": 0.0,
                       "consumer_wait_s": 0.0, "max_queue_depth": 0}
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="raytpu-ingest-producer")
        self._thread.start()

    # -- producer side ----------------------------------------------------

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                self._q.put(item, timeout=0.1)
            except queue.Full:
                waited = time.perf_counter() - t0
                self._stats["producer_wait_s"] += waited
                self._obs.inc("ingest_producer_wait_seconds", waited)
                continue
            waited = time.perf_counter() - t0
            if waited > 0.005:
                self._stats["producer_wait_s"] += waited
                self._obs.inc("ingest_producer_wait_seconds", waited)
            depth = self._q.qsize()
            self._stats["max_queue_depth"] = max(
                self._stats["max_queue_depth"], depth)
            self._obs.set("ingest_queue_depth", depth)
            return True
        return False

    def _run(self):
        try:
            for batch in batches_from_block_iter(
                    self._blocks, self._batch_size, self._drop_last,
                    self._obs):
                if self._stage is not None:
                    batch = self._stage(batch)
                self._stats["batches"] += 1
                self._obs.inc("ingest_batches")
                if not self._put(batch):
                    return
        except BaseException as e:  # noqa: BLE001 — crosses to the consumer
            self._error = e
        finally:
            try:
                self._q.put(_DONE, timeout=60)
            except queue.Full:
                pass

    # -- consumer side ----------------------------------------------------

    def __iter__(self) -> Iterator[Any]:
        try:
            while True:
                tok = self._obs.begin("ingest", "ingest_wait")
                t0 = time.perf_counter()
                item = self._q.get()
                waited = time.perf_counter() - t0
                self._obs.end(tok, depth=self._q.qsize())
                self._obs.set("ingest_queue_depth", self._q.qsize())
                self._obs.inc("ingest_consumer_wait_seconds", waited)
                self._stats["consumer_wait_s"] += waited
                if waited > 0.01:
                    # The training thread sat idle on an empty queue.
                    self._obs.record("ingest", "producer_starved",
                                     wait_s=round(waited, 6))
                if item is _DONE:
                    if self._error is not None:
                        raise self._error
                    return
                yield item
        finally:
            self.close()

    def stats(self) -> dict:
        return dict(self._stats)

    def close(self):
        self._stop.set()
        # Drain so a producer blocked on put() wakes and exits.
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)


def _plain(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a numpy column (copied if read-only, since
    torch tensors are writable)."""
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


class _Staging:
    """The pinned host buffers of a CUDA feed.  A slot is handed out to
    the producer only after the H2D copy from it, recorded by an event,
    has completed; the consumer returns each slot with its copy's event
    as soon as it has enqueued the copy."""

    def __init__(self, slots: int):
        self._free: queue.Queue = queue.Queue()
        self._buffers: list = [{} for _ in range(slots)]
        for i in range(slots):
            self._free.put((i, None))

    def stage(self, batch: Block):
        slot, event = self._free.get()
        if event is not None:
            event.synchronize()
        bufs = self._buffers[slot]
        out = {}
        for k, arr in batch.items():
            src = _plain(np.ascontiguousarray(arr))
            buf = bufs.get(k)
            if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                buf = bufs[k] = torch.empty(src.shape, dtype=src.dtype,
                                            pin_memory=True)
            buf.copy_(src)
            out[k] = buf
        return slot, out

    def release(self, slot: int, event) -> None:
        self._free.put((slot, event))


class DeviceBatchIterator:
    """Keeps up to `buffers` batches in flight on the device: while the
    step consumes batch k, batch k+1's copy has already been enqueued.
    Never holds more than `buffers` device batches."""

    def __init__(self, block_iter: Iterable[Block], batch_size: int, *,
                 device: DeviceLike = None, drop_last: bool = False,
                 queue_depth: Optional[int] = None,
                 buffers: Optional[int] = None,
                 observer: Optional[Observer] = None):
        self._device = resolve_device(device)
        self._buffers = max(1, int(buffers if buffers is not None
                                   else DEVICE_BUFFERS))
        self._obs = observer or NOOP
        self._staging = None
        stage = None
        if self._device.type == "cuda":
            depth = queue_depth if queue_depth is not None else QUEUE_DEPTH
            # Queued batches, the one each thread holds and those whose
            # copy may still run: a free slot is then normally ready.
            self._staging = _Staging(max(1, int(depth)) + self._buffers + 2)
            stage = self._staging.stage
        self._producer = BatchProducer(block_iter, batch_size, drop_last,
                                       queue_depth, stage, self._obs)
        self._max_inflight = 0

    def _to_device(self, item):
        tok = self._obs.begin("ingest", "h2d")
        try:
            if self._staging is None:
                return {k: _plain(v) for k, v in item.items()}, None
            slot, pinned = item
            side = self._side
            with torch.cuda.stream(side):
                batch = {k: v.to(self._device, non_blocking=True)
                         for k, v in pinned.items()}
                event = torch.cuda.Event()
                event.record(side)
            self._staging.release(slot, event)
            return batch, event
        finally:
            self._obs.end(tok)

    def _hand_out(self, batch, event):
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in batch.values():
                t.record_stream(consumer)
        return batch

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        if self._staging is not None:
            self._side = torch.cuda.Stream(self._device)
        inflight: deque = deque()
        try:
            for item in self._producer:
                inflight.append(self._to_device(item))
                self._max_inflight = max(self._max_inflight, len(inflight))
                if len(inflight) >= self._buffers:
                    yield self._hand_out(*inflight.popleft())
            while inflight:
                yield self._hand_out(*inflight.popleft())
        finally:
            self.close()

    def stats(self) -> dict:
        out = self._producer.stats()
        out["max_device_inflight"] = self._max_inflight
        out["device_buffers"] = self._buffers
        return out

    def close(self):
        self._producer.close()


def iter_device_batches(source, *, device: DeviceLike = None,
                        batch_size: int = 256, drop_last: bool = False,
                        queue_depth: Optional[int] = None,
                        device_buffers: Optional[int] = None,
                        observer: Optional[Observer] = None
                        ) -> DeviceBatchIterator:
    """The overlapped device feed over `source` on `device` (None ->
    CUDA): an iterable of blocks (dicts of numpy columns), or a shard —
    anything with `iter_batches(batch_size=, batch_format="numpy",
    drop_last=)`, such as the reference's `session.get_dataset_shard`.
    Batches of `batch_size` rows, as dicts of tensors on the device."""
    if hasattr(source, "iter_batches"):
        source = source.iter_batches(batch_size=batch_size,
                                     batch_format="numpy",
                                     drop_last=drop_last)
    return DeviceBatchIterator(source, batch_size, device=device,
                               drop_last=drop_last, queue_depth=queue_depth,
                               buffers=device_buffers, observer=observer)
