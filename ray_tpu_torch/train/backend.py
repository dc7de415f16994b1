"""The training fabric's CUDA backend (the port's counterpart of
ray_tpu/train/backend.py's TpuConfig/TpuBackend): each worker of a gang
is pinned to its card and joins one `torch.distributed` process group,
nccl on CUDA, gloo on the CPU.

It plugs into the reference's trainer by duck typing and imports
nothing of it: `DataParallelTrainer(..., backend_config=CudaConfig())`
calls `backend_config.backend_cls()()`, then `on_start`,
`on_training_start` and `on_shutdown` with the worker group, of which
only `execute`, `execute_single`, `local_ranks` and each worker's `pid`
are used.  The reference's host daemon turns only `--num-tpus` into a
resource, so a caller asks for cards with
`ray_tpu.init(resources={"GPU": n})` and
`ScalingConfig(resources_per_worker={"GPU": 1})`.
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch._device import resolve_device


@dataclass
class CudaConfig:
    """`device=None` means each worker's CUDA card (nccl); "cpu" runs the
    group on gloo, as the CPU tests do.  Each worker takes the card of
    its local rank."""

    device: Optional[str] = None
    init_timeout_s: float = 120.0

    def backend_cls(self):
        return CudaBackend


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _host() -> str:
    return socket.gethostbyname(socket.gethostname())


def _init_worker(ranks: Dict[int, Tuple[int, int]], world_size: int,
                 address: str, config: CudaConfig) -> dict:
    """Runs on every worker at once: find this worker's (rank, local
    rank) by its pid, pin it to its card and join the group."""
    rank, local_rank = ranks[os.getpid()]
    device = resolve_device(config.device)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        init_method=address, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=config.init_timeout_s))
    return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "device": str(torch.device("cuda", local_rank)
                          if device.type == "cuda" else device)}


def _shutdown_worker() -> bool:
    if dist.is_initialized():
        dist.destroy_process_group()
    return True


class CudaBackend:
    """Hooks around the training lifecycle (the reference's Backend
    contract)."""

    def on_start(self, worker_group, config: CudaConfig):
        local = worker_group.local_ranks()
        n = len(local)
        port = worker_group.execute_single(0, _free_port)
        # A gang on one host meets on the loopback.
        host = "127.0.0.1" if all(size == n for _, size in local) \
            else worker_group.execute_single(0, _host)
        # One execute for every rank at once: the group's rendezvous
        # blocks until all of them join, so no call may wait on one rank alone.
        ranks = {w.pid: (rank, local[rank][0])
                 for rank, w in enumerate(worker_group.workers)}
        infos = worker_group.execute(_init_worker, ranks, n,
                                     f"tcp://{host}:{port}", config)
        if sorted(i["rank"] for i in infos) != list(range(n)) or any(
                i["world_size"] != n for i in infos):
            raise RuntimeError(f"torch process group mismatch: {infos}")
        return infos

    def on_training_start(self, worker_group, config: CudaConfig):
        pass

    def on_shutdown(self, worker_group, config: CudaConfig):
        worker_group.execute(_shutdown_worker)
