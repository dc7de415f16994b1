"""Async save path (port of ray_tpu/checkpoint/async_writer.py): the
device-to-host copy at the step boundary, the I/O on a thread.

`AsyncCheckpointer.save()` blocks only for `sharded.stage` (the copy of
the tensors to host memory), after which the train step may update the
live tensors in place; the file writes, fsyncs and the commit rename run
on a background writer thread against the host snapshot.  At most ONE
save is in flight: each `save()` force-joins the previous one first, and
`wait_until_finished()` is an explicit barrier.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from ray_tpu_torch.checkpoint import sharded
from ray_tpu_torch.util.observe import Observer


class CheckpointWriteError(RuntimeError):
    """A background checkpoint write failed (raised at the next barrier:
    wait_until_finished() or the force-join inside the next save())."""


class SaveHandle:
    """Ticket for one (possibly in-flight) checkpoint write; across
    processes, progress is read from the COMMIT marker on the shared
    filesystem (`committed()`)."""

    def __init__(self, directory: str, step: Optional[int] = None):
        self.directory = directory
        self.step = step
        self._event = threading.Event()
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        """True once the local writer thread finished (success or not)."""
        return self._event.is_set()

    def committed(self) -> bool:
        """True once the COMMIT marker exists — the only signal that is
        meaningful across processes."""
        return sharded.is_committed(self.directory)

    def wait(self, timeout: Optional[float] = None) -> str:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"checkpoint write to {self.directory} still in flight "
                f"after {timeout}s")
        if self._error is not None:
            raise CheckpointWriteError(
                f"checkpoint write to {self.directory} failed"
            ) from self._error
        return self.directory

    def __repr__(self):
        state = ("committed" if self.committed()
                 else "done" if self.done() else "in-flight")
        return f"SaveHandle({self.directory}, step={self.step}, {state})"


class AsyncCheckpointer:
    """One background writer; at most one save in flight."""

    def __init__(self, observer: Optional[Observer] = None):
        self._observer = observer
        self._thread: Optional[threading.Thread] = None
        self._handle: Optional[SaveHandle] = None
        self._lock = threading.Lock()

    def save(self, directory: str, tree: Any, *, step: Optional[int] = None,
             metrics: Optional[dict] = None, save_id: str = "0",
             sync: bool = False, commit: bool = True) -> SaveHandle:
        """Snapshot `tree` to host and hand the write to the background
        thread; returns as soon as the snapshot exists.  Force-joins any
        previous in-flight save first; `sync=True` writes before
        returning."""
        with self._lock:
            self.wait_until_finished()
            staged = sharded.stage(tree, save_id=save_id, step=step,
                                   metrics=metrics, observer=self._observer)
            handle = SaveHandle(directory, step)

            def _write():
                try:
                    sharded.write_staged(staged, directory, commit=commit,
                                         observer=self._observer)
                except BaseException as e:  # noqa: BLE001 — surfaces at wait
                    handle._error = e
                finally:
                    handle._event.set()

            self._handle = handle
            if sync:
                _write()
                if handle._error is not None:
                    handle.wait(0)
            else:
                t = threading.Thread(
                    target=_write, daemon=True,
                    name=f"ckpt-writer-{step if step is not None else ''}")
                self._thread = t
                t.start()
            return handle

    def wait_until_finished(self) -> None:
        """Barrier: block until the in-flight write (if any) hits disk;
        re-raises its failure, once."""
        t, h = self._thread, self._handle
        if t is not None:
            t.join()
            self._thread = None
        if h is not None and h.done() and h._error is not None:
            self._handle = None
            h.wait(0)   # raises CheckpointWriteError

    @property
    def in_flight(self) -> Optional[SaveHandle]:
        h = self._handle
        return h if h is not None and not h.done() else None
