#!/usr/bin/env python3
"""Which collectives a gloo group takes on CUDA tensors, ranks sharing
one card.

    python3 scripts/probe_collectives.py [--ranks 2] [--device cuda]

Spawns `--ranks` processes on device 0 (or the CPU) joined by a gloo
group through a file store, and tries each collective that the mesh
path needs: all_reduce (SUM, MAX), all_gather_into_tensor,
reduce_scatter_tensor, all_to_all_single, broadcast, a DTensor
Shard -> Replicate redistribute on a mesh of the device's type (and of
a _StridedShard placement), torch.optim.AdamW (fused and foreach)
over DTensor parameters, and the point-to-point rotation of ring
attention (each rank sends to the next and receives from the one
before): `batch_isend_irecv`, `all_to_all_single` with zero-size splits
to every rank but the neighbours, and `parallel.collectives.ppermute`
itself.  Each result is "ok" or the first line of the
error (or that the process died: such a check is named, and the
remaining ones run in a new group); a collective that ran is checked
against its expected value, and all_reduce, all_gather,
reduce_scatter and the rotations are timed (median of 10 calls on a
3 MiB bf16 tensor, the host clock around a synchronize), beside an
all_reduce staged by hand through pinned host memory.  The group has a
60 s timeout, so an op that never completes is reported as an error.  The parent prints one JSON line.
`ray_tpu_torch.parallel.collectives` stages through host memory the ops
that this probe found refused.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import statistics
import sys
import tempfile
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import torch.multiprocessing as mp

TIMED_ELEMENTS = 3 * 2 ** 20 // 2       # 3 MiB of bf16


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device) -> float:
    times = []
    for _ in range(11):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def _checks(rank, n, device) -> dict:
    """name -> a function returning True when the op gave the right
    value, or a number of milliseconds for the timed ops."""
    checks = {}

    def all_reduce(op, want, dtype=torch.float32):
        def run():
            t = torch.full((4,), float(rank + 1), dtype=dtype, device=device)
            dist.all_reduce(t, op=op)
            return bool((t.float() == want).all())
        return run

    checks["all_reduce_sum"] = all_reduce(dist.ReduceOp.SUM, n * (n + 1) / 2)
    checks["all_reduce_max"] = all_reduce(dist.ReduceOp.MAX, float(n))
    checks["all_reduce_sum_bf16"] = all_reduce(dist.ReduceOp.SUM,
                                               n * (n + 1) / 2,
                                               torch.bfloat16)

    def all_gather():
        t = torch.full((2,), float(rank), device=device)
        out = torch.empty(2 * n, device=device)
        dist.all_gather_into_tensor(out, t)
        return bool((out == torch.arange(n, device=device)
                     .repeat_interleave(2).float()).all())
    checks["all_gather_into_tensor"] = all_gather

    def reduce_scatter():
        t = torch.arange(2 * n, dtype=torch.float32, device=device)
        out = torch.empty(2, device=device)
        dist.reduce_scatter_tensor(out, t)
        return bool((out == n * t[2 * rank:2 * rank + 2]).all())
    checks["reduce_scatter_tensor"] = reduce_scatter

    def all_to_all():
        t = torch.full((n,), float(rank), device=device)
        out = torch.empty(n, device=device)
        dist.all_to_all_single(out, t)
        return bool((out == torch.arange(n, device=device).float()).all())
    checks["all_to_all_single"] = all_to_all

    def broadcast():
        t = torch.full((3,), float(rank), device=device)
        dist.broadcast(t, src=0)
        return bool((t == 0).all())
    checks["broadcast"] = broadcast

    def dtensor_redistribute():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)
        mesh = init_device_mesh(device.type, (n,))
        full = torch.arange(4 * n, dtype=torch.float32, device=device)
        dt = distribute_tensor(full, mesh, [Shard(0)])
        return bool((dt.redistribute(mesh, [Replicate()]).to_local()
                     == full).all())
    checks["dtensor_shard_to_replicate"] = dtensor_redistribute

    def strided_full_tensor():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Shard
        from torch.distributed.tensor.placement_types import _StridedShard
        mesh = init_device_mesh(device.type, (2, n // 2),
                                mesh_dim_names=("fsdp", "tensor"))
        fi, ti = divmod(rank, n // 2)
        full = torch.arange(4 * n, dtype=torch.float32, device=device)
        # ("tensor", "fsdp") on dim 0: tensor-major blocks.
        local = full.chunk(n)[ti * 2 + fi]
        dt = DTensor.from_local(local, mesh, [
            _StridedShard(0, split_factor=n // 2), Shard(0)],
            run_check=False)
        return bool((dt.full_tensor() == full).all())
    checks["dtensor_strided_full_tensor"] = strided_full_tensor

    def adamw(fused):
        def run():
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import Shard, distribute_tensor
            mesh = init_device_mesh(device.type, (n,))
            p = distribute_tensor(torch.ones(2 * n, device=device), mesh,
                                  [Shard(0)]).requires_grad_()
            kw = {"fused": True} if fused else {"foreach": True}
            opt = torch.optim.AdamW([p], lr=0.1, weight_decay=0.0, **kw)
            p.sum().backward()
            opt.step()
            return bool(torch.allclose(p.to_local(), torch.full(
                (2,), 0.9, device=device)))
        return run
    checks["adamw_fused_dtensor"] = adamw(True)
    checks["adamw_foreach_dtensor"] = adamw(False)

    nxt, prv = (rank + 1) % n, (rank - 1) % n

    def rotate_p2p(t):
        out = torch.empty_like(t)
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, t, nxt),
                dist.P2POp(dist.irecv, out, prv)]):
            work.wait()
        return out

    def rotate_a2a(t):
        out = torch.empty_like(t)
        send = [0] * n
        recv = [0] * n
        send[nxt] = recv[prv] = t.shape[0]
        dist.all_to_all_single(out, t, output_split_sizes=recv,
                               input_split_sizes=send)
        return out

    def rotate_port(t):
        from ray_tpu_torch.parallel.collectives import ppermute
        return ppermute(t, dist.group.WORLD)

    def rotation(fn):
        def run():
            t = torch.full((5,), float(rank), device=device)
            return bool((fn(t) == float(prv)).all())
        return run
    checks["p2p_batch_isend_irecv"] = rotation(rotate_p2p)
    checks["p2p_all_to_all_single_rotation"] = rotation(rotate_a2a)
    checks["p2p_collectives_ppermute"] = rotation(rotate_port)

    big = torch.ones(TIMED_ELEMENTS, dtype=torch.bfloat16, device=device)
    gathered = torch.empty(TIMED_ELEMENTS * n, dtype=big.dtype,
                           device=device)
    part = torch.empty(TIMED_ELEMENTS // n, dtype=big.dtype, device=device)
    host = torch.empty(TIMED_ELEMENTS, dtype=big.dtype,
                       pin_memory=device.type == "cuda")
    back = torch.empty_like(big)

    def staged_all_reduce():
        host.copy_(big)
        dist.all_reduce(host)
        back.copy_(host)
    checks["ms_all_reduce"] = lambda: _timed(lambda: dist.all_reduce(big),
                                             device)
    checks["ms_all_gather"] = lambda: _timed(
        lambda: dist.all_gather_into_tensor(gathered, big), device)
    checks["ms_reduce_scatter"] = lambda: _timed(
        lambda: dist.reduce_scatter_tensor(part, big), device)
    checks["ms_host_staged_all_reduce"] = lambda: _timed(staged_all_reduce,
                                                         device)
    checks["ms_p2p_batch_isend_irecv"] = lambda: _timed(
        lambda: rotate_p2p(big), device)
    checks["ms_p2p_all_to_all_single_rotation"] = lambda: _timed(
        lambda: rotate_a2a(big), device)
    checks["ms_p2p_collectives_ppermute"] = lambda: _timed(
        lambda: rotate_port(big), device)
    return checks


def _rank(rank, world, device_type, init, names, out_path):
    """Run the checks `names` in order; rank 0 rewrites `out_path` with
    the results so far and the check it is about to run, so a check
    that kills the process is named by the parent."""
    device = torch.device(device_type, 0) if device_type == "cuda" \
        else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    checks = _checks(rank, world, device)
    res: dict = {}
    for name in names:
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump({"results": res, "running": name}, f)
        try:
            value = checks[name]()
            res[name] = {"ok": value} if isinstance(value, bool) \
                else {"ok": True, "ms": value}
        except Exception as exc:           # a probe records refusals
            first = (str(exc).strip().splitlines()
                     or [type(exc).__name__])[0]
            res[name] = {"ok": False, "error": f"{type(exc).__name__}: "
                                               f"{first[:240]}"}
        dist.barrier()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({"results": res, "running": None}, f)
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_collectives: no CUDA device", file=sys.stderr)
        return 1
    todo = list(_checks(0, args.ranks, torch.device("cpu")))
    results: dict = {}
    while todo:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "result.json")
            try:
                mp.start_processes(_rank, args=(
                    args.ranks, args.device, f"file://{tmp}/store", todo,
                    out), nprocs=args.ranks, start_method="spawn")
                crashed = None
            except mp.ProcessExitedException as exc:
                crashed = f"the process died: {exc}"
            except mp.ProcessRaisedException as exc:
                # A peer of a rank that died can raise first (its
                # connection closed).
                last = str(exc).strip().splitlines()[-1][:200]
                crashed = f"a rank died or raised: {last}"
            with open(out) as f:
                state = json.load(f)
        results.update(state["results"])
        if crashed is not None and state["running"] is not None:
            results[state["running"]] = {"ok": False, "error": crashed}
        todo = [n for n in todo if n not in results]
    print(json.dumps({"probe": "collectives", "backend": "gloo",
                      "device": args.device, "ranks": args.ranks,
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
