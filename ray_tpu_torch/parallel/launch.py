"""Spawn the ranks of a mesh and collect what each returns.

    results = run_ranks(fn, 8, device="cpu", init_dir=tmp, timeout_s=300)

    with RankGang(2, device="cpu", init_dir=tmp, timeout_s=300) as gang:
        gang.call(build, config)             # each rank keeps its state
        metrics = gang.call(update, batch)   # ... between calls

`run_ranks` runs `fn(rank, world_size, *args)` once on `world_size`
processes; a `RankGang` keeps its ranks and their process group up, and
each `call(fn, *args)` runs `fn(rank, world_size, state, *args)` on
every rank, `state` a dict that the rank keeps between calls (a
learner group builds its learner in one call and updates it in the
next; `run(fn, *args)` runs `fn(rank, world_size, *args)`, as
`run_ranks` does, on ranks already up).  On a card a rank empties its
allocator's cache after each call.  The ranks are started with
`torch.multiprocessing` (start method "spawn", so a child imports only
`fn`'s module and what it imports) and join one process group through
a `file://` store under `init_dir` (no fixed TCP port, so groups of
concurrent callers never collide): NCCL when every rank has a card of
its own (`torch.cuda.device_count() >= world_size`), else gloo with
every rank on card 0 (CUDA tensors through gloo) or on the CPU; the gang prints
the backend it chose to standard error.  On the CPU each rank runs one
thread.  A call goes to the ranks through a pickle file in `init_dir`,
not the spawn pipe: a spawned child's arguments travel through a pipe
that the parent writes while the child imports `fn`'s module, so
arguments larger than the pipe's buffer would start the ranks one after
another.  `fn` returns a picklable value, and a call returns the list
by rank.  A call raises if a rank raises or dies, or if it has not
finished within `timeout_s` (of the call; the first call's includes
the ranks' start): every rank is then killed and the gang is closed,
so a hung rank fails its caller instead of stalling it.  Calls from
several threads run one at a time.  `choose_backend` says which backend
a group of `world_size` would take.
"""

from __future__ import annotations

import gc
import os
import pickle
import queue
import sys
import threading
import time
import traceback
from typing import Any, Callable, List, Optional

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device


def choose_backend(world_size: int, device: DeviceLike = None) -> str:
    """"nccl" when each of `world_size` ranks has a card of its own,
    else "gloo" (ranks share card 0, or run on the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def _child(rank: int, world_size: int, device: str, backend: str,
           init: str, commands, results) -> None:
    import torch.distributed as dist

    try:
        if device == "cuda":
            torch.cuda.set_device(rank if backend == "nccl" else 0)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world_size)
        state: dict = {}
        try:
            while (path := commands.get()) is not None:
                with open(path, "rb") as f:
                    fn, args = pickle.load(f)
                out = fn(rank, world_size, state, *args)
                results.put((rank, True, pickle.dumps(out)))
                del out
                if device == "cuda":        # calls share the card
                    gc.collect()
                    torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    except BaseException:                    # reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise


class RankGang:
    """`world_size` spawned ranks in one process group that stay up
    until `close()` (see the module docstring)."""

    def __init__(self, world_size: int, *, device: DeviceLike = None,
                 init_dir: str, timeout_s: float):
        import torch.multiprocessing as mp

        dev = resolve_device(device)
        backend = choose_backend(world_size, dev)
        print(f"RankGang: {world_size} ranks over {backend} on {dev.type}",
              file=sys.stderr, flush=True)
        self.world_size, self.timeout_s = world_size, timeout_s
        os.makedirs(init_dir, exist_ok=True)
        self._store = os.path.join(init_dir,
                                   f"store-{os.getpid()}-{time.time_ns()}")
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._commands = [ctx.Queue() for _ in range(world_size)]
        self._procs: Optional[list] = [ctx.Process(target=_child, args=(
            rank, world_size, dev.type, backend, f"file://{self._store}",
            self._commands[rank], self._results), daemon=True)
            for rank in range(world_size)]
        for p in self._procs:
            p.start()
        self._lock = threading.Lock()
        self._calls = 0

    def call(self, fn: Callable, *args) -> List[Any]:
        """`fn(rank, world_size, state, *args)` on every rank; the
        results by rank."""
        with self._lock:
            if self._procs is None:
                raise RuntimeError("RankGang: the gang is closed")
            path = f"{self._store}.call{self._calls}"
            self._calls += 1
            with open(path, "wb") as f:
                pickle.dump((fn, args), f)
            try:
                for q in self._commands:
                    q.put(path)
                got, error = self._collect()
            finally:
                os.remove(path)
            if error is not None:
                self._stop(kill=True)
                raise RuntimeError(error)
            return [got[r] for r in range(self.world_size)]

    @property
    def closed(self) -> bool:
        return self._procs is None

    def run(self, fn: Callable, *args) -> List[Any]:
        """`fn(rank, world_size, *args)` on every rank (no state): what
        `run_ranks` runs, on ranks already up."""
        return self.call(_once, fn, *args)

    def _collect(self):
        n = self.world_size
        deadline = time.monotonic() + self.timeout_s
        got: dict = {}
        while len(got) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                return got, (f"RankGang: {n - len(got)} of {n} ranks had "
                             f"not finished after {self.timeout_s} s")
            try:
                rank, ok, payload = self._results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [i for i, p in enumerate(self._procs)
                        if i not in got and p.exitcode is not None]
                if dead:
                    return got, (f"RankGang: rank {dead[0]} exited with "
                                 f"code {self._procs[dead[0]].exitcode}")
                continue
            if not ok:
                return got, f"RankGang: rank {rank} raised:\n{payload}"
            got[rank] = pickle.loads(payload)
        return got, None

    def _stop(self, kill: bool) -> None:
        procs, self._procs = self._procs, None
        if procs is None:
            return
        if not kill:
            for q in self._commands:
                q.put(None)
        for p in procs:
            p.join(timeout=0.1 if kill else 10)
            if p.is_alive():
                p.kill()
                p.join()
        try:
            os.remove(self._store)
        except FileNotFoundError:
            pass

    def close(self) -> None:
        """End the ranks (killed if they do not exit within 10 s)."""
        with self._lock:
            self._stop(kill=False)

    def __enter__(self) -> "RankGang":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _once(rank: int, world_size: int, state: dict, fn: Callable, *args):
    return fn(rank, world_size, *args)


def run_ranks(fn: Callable, world_size: int, *, args: tuple = (),
              device: DeviceLike = None, init_dir: str,
              timeout_s: float) -> List[Any]:
    """Run `fn(rank, world_size, *args)` on `world_size` spawned ranks
    and return their results by rank: a `RankGang` making one call."""
    with RankGang(world_size, device=device, init_dir=init_dir,
                  timeout_s=timeout_s) as gang:
        return gang.run(fn, *args)
