"""Spawn the ranks of a mesh and collect what each returns.

    results = run_ranks(fn, 8, device="cpu", init_dir=tmp, timeout_s=300)

`fn(rank, world_size, *args)` runs in each of `world_size` processes
started with `torch.multiprocessing` (start method "spawn", so a child
imports only `fn`'s module and what it imports).  The ranks join one
process group through a `file://` store under `init_dir` (no fixed TCP
port, so groups of concurrent callers never collide): NCCL when every
rank has a card of its own (`torch.cuda.device_count() >= world_size`),
else gloo with every rank on card 0 (CUDA tensors through gloo) or on
the CPU; it prints the backend it chose to standard error.  On the
CPU each rank runs one thread.  `fn` returns a
picklable value; `run_ranks` returns the list by rank, and raises if a
rank raises or dies, or if the group has not finished within
`timeout_s` (every child is then killed), so a hung rank fails its
caller instead of stalling it.  `choose_backend` says which backend a
group of `world_size` would take.
"""

from __future__ import annotations

import os
import pickle
import queue
import sys
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
           init: str, call_path: str, results) -> None:
    import torch.distributed as dist

    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        if device == "cuda":
            torch.cuda.set_device(rank if backend == "nccl" else 0)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world_size)
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:                    # reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world_size: int, *, args: tuple = (),
              device: DeviceLike = None, init_dir: str,
              timeout_s: float) -> List[Any]:
    """Run `fn(rank, world_size, *args)` on `world_size` spawned ranks
    and return their results by rank (see the module docstring)."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    backend = choose_backend(world_size, dev)
    print(f"run_ranks: {world_size} ranks over {backend} on {dev.type}",
          file=sys.stderr, flush=True)
    os.makedirs(init_dir, exist_ok=True)
    store = os.path.join(init_dir, f"store-{os.getpid()}-{time.time_ns()}")
    # The call goes to the children through a file: a spawned child's
    # arguments travel through a pipe that the parent writes while the
    # child imports `fn`'s module, so arguments larger than the pipe's
    # buffer would start the ranks one after another.
    call_path = store + ".call"
    with open(call_path, "wb") as f:
        pickle.dump((fn, args), f)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(
        rank, world_size, dev.type, backend, f"file://{store}", call_path,
        results), daemon=True) for rank in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got: dict = {}
    error: Optional[str] = None
    try:
        while len(got) < world_size and error is None:
            left = deadline - time.monotonic()
            if left <= 0:
                error = (f"run_ranks: {world_size - len(got)} of "
                         f"{world_size} ranks had not finished after "
                         f"{timeout_s} s")
                break
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in got and p.exitcode not in (None, 0)]
                if dead:
                    error = (f"run_ranks: rank {dead[0]} exited with code "
                             f"{procs[dead[0]].exitcode}")
                continue
            if ok:
                got[rank] = pickle.loads(payload)
            else:
                error = f"run_ranks: rank {rank} raised:\n{payload}"
    finally:
        for p in procs:
            p.join(timeout=5 if error is None else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
        for path in (store, call_path):
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
    if error is not None:
        raise RuntimeError(error)
    return [got[r] for r in range(world_size)]
