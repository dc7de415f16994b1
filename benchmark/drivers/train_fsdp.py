"""A training cell over the cards of one host under FSDP: the port's train
step on a mesh whose `fsdp` axis is the cell's chips, one rank a card
(NCCL), fed fresh rows from the seed, timed over whole steps.

The ranks are a `RankGang` of spawned processes; this process starts
them, hands each its calls, reads what they return and touches no card
itself.  Each rank runs `train.Setup` under the mesh: it draws the whole
weights from the seed on its card leaf by leaf and keeps its shard of
each, drives the state through the checked first steps with the
window's own call and feed, and reads its part of each leaf's first
gradient and change (a norm is summed over the ranks).  Every rank draws
each batch whole from the seed on its card; the train step takes the
rank's rows.  The window (`train.window`) runs on every rank: it opens
on a synchronise of every rank, runs on rank 0's host clock over whole
steps (rank 0 decides after each step whether the window's seconds have
passed, and every rank takes its decision by a broadcast over a gloo
group, off the cards' streams), and closes on a synchronise of every
rank.  The peak is the largest over the ranks; a traced run profiles
rank 0.  After the window each rank frees the program's state and the
plain reference runs data parallel over the same ranks
(`train_reference.DataParallel`), each rank judging its part.  The
program runs in the ranks, so this process's `sys.modules` cannot show
what it loads: the last call of every gang asks each rank for the
forbidden modules it holds, and a rank that holds one fails the run.
"""

from __future__ import annotations

import contextlib
import shutil
import statistics
import sys
import tempfile

import torch

from benchmark import harness
from benchmark.drivers import train
from benchmark.drivers._common import log, now

# Seconds a call to the ranks may take before they are killed and the
# run fails (the first call's include the ranks' start and, in a fresh
# checkout, the kernels' build).
RANK_TIMEOUT_S = 1200


def _device(device: str) -> torch.device:
    if device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _setup(rank: int, world: int, state: dict, spec: dict, seed: int,
           device: str) -> str:
    """The rank's `train.Setup` under the mesh, kept in `state`; the
    card's name."""
    import torch.distributed as dist
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    if "host_group" not in state:
        state["host_group"] = dist.new_group(backend="gloo")
    dev = _device(device)
    mesh = create_mesh(MeshConfig(fsdp=world), device=device)
    state["setup"] = train.Setup(spec, seed, dev, mesh)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _window(rank: int, world: int, state: dict, seconds: float,
            traced: bool) -> dict:
    """`train.window` on every rank, rank 0 deciding when it ends and
    profiled when `traced`; then the program's state is freed."""
    import torch.distributed as dist

    setup, group = state["setup"], state["host_group"]

    def agree(stop: bool) -> bool:
        flag = torch.tensor([int(stop)])
        dist.broadcast(flag, 0, group=group)
        return bool(flag[0])

    def barrier() -> None:
        if setup.device.type == "cuda":
            torch.cuda.synchronize(setup.device)
        dist.barrier(group=group)

    win = train.window(setup, seconds, traced and rank == 0, agree, barrier)
    setup.close()
    return win


def _check(rank: int, world: int, state: dict) -> tuple:
    """(the program's readings, the reference's) as norms: the
    reference data parallel over the ranks, judging each rank's part."""
    setup = state.pop("setup")
    ref = setup.reference()
    prog = {k: setup.readings[k]
            for k in ("losses", "grad_norms", "change_norms")}
    return prog, ref


def _free(rank: int, world: int, state: dict) -> None:
    state["setup"].close()


def _readings(rank: int, world: int, state: dict, control: bool) -> dict:
    setup = state.pop("setup")
    if control:
        return setup.controls()
    ref = setup.reference()
    return {"program": dict(train.compare(setup.readings, ref)),
            "worst": train.worst_leaves(setup.readings, ref)}


def _forbidden(rank: int, world: int, state: dict) -> list:
    return harness.forbidden_modules()


@contextlib.contextmanager
def _gang(world: int, device):
    """A gang of `world` ranks on `device` (its store in a fresh
    temporary directory), closed on leaving; once the body has run, a
    rank that has loaded a forbidden module fails the run."""
    from ray_tpu_torch.parallel import launch

    tmp = tempfile.mkdtemp(prefix="benchmark-ranks-")
    try:
        with launch.RankGang(world, device=device, init_dir=tmp,
                             timeout_s=RANK_TIMEOUT_S) as gang:
            yield gang
            found = {r: names for r, names in enumerate(gang.call(_forbidden))
                     if names}
        if found:
            raise harness.BenchError("forbidden modules loaded: " + "; ".join(
                f"rank {r}: {', '.join(names)}" for r, names in found.items()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _step_seconds(done: list) -> str:
    """The spread of rank 0's whole steps in the window, as its host saw
    each end."""
    steps = [b - a for a, b in zip(done, done[1:])]
    if len(steps) < 4:
        return f"{len(steps)} step(s)"
    q1, q2, q3 = statistics.quantiles(steps, n=4)
    return (f"step s median {q2:.4f}, quartiles {q1:.4f} / {q3:.4f}, "
            f"min {min(steps):.4f}, max {max(steps):.4f}")


def run(spec: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> dict:
    world = spec["cell"]["chips"]
    with _gang(world, device) as gang:
        kind = gang.call(_setup, spec, seed, str(device))[0]
        wins = gang.call(_window, seconds, traced)
        win = wins[0]
        log(f"setup {win['t0'] - t_start:.3f} s, {win['steps']} steps in "
            f"the window over {world} ranks", win["t0"])
        print(f"benchmark: {_step_seconds(win['done'])}", file=sys.stderr)
        t_ref = now()
        prog, ref = gang.call(_check)[0]
        log("reference", t_ref)
    train.log_worst(prog, ref)
    out = {"ctx": train.train_ctx(spec, win, win["t0"] - t_start),
           "checks": train.compare(prog, ref),
           "attempted": win["steps"], "failed": 0,
           "memory_peak_bytes": max(w["peak"] for w in wins)}
    if kind != "cpu":
        out["device_kind"] = kind
    return out


def readings(spec: dict, seed: int, device, seconds: float,
             control: bool) -> dict:
    """`train.readings` over the ranks of a gang of its own: the
    program's numbers at `seed` and, with `control`, the control's and
    the faults', the gradients' exchange left out among them."""
    with _gang(spec["cell"]["chips"], device) as gang:
        gang.call(_setup, spec, seed, str(device))
        gang.call(_free)
        return gang.call(_readings, control)[0]


def tiny(mix: dict) -> dict:
    """The mix at the CPU tests' sizes: two rows of 64 a rank."""
    return dict(mix, rows=8, length=64, trace_seconds=0.5)
