"""What the drivers share: the program's family and configuration object
for a cell, and a fence that waits for the device."""

from __future__ import annotations

import sys
import time

import torch

from benchmark import harness


def now() -> float:
    return time.perf_counter()


def log(what: str, since: float) -> None:
    """One line on standard error: a phase and its host seconds."""
    print(f"benchmark: {what} {now() - since:.3f} s", file=sys.stderr,
          flush=True)


def program(spec: dict, **overrides) -> tuple:
    """(the port's family module, its configuration object) for the
    cell: the family that `run.family` names, the object of that
    family's configuration class with the fields that the reference's
    `program_config` gives."""
    from ray_tpu_torch.models import family

    fam = family(spec["config"]["run"]["family"])
    fields = harness.reference(spec).program_config(
        spec["config"]["run"], **overrides)
    config_class = type(next(iter(fam.CONFIGS.values())))
    return fam, config_class(**fields)


class Fence:
    """Marks a point in the device's stream of work; `wait()` returns
    once the device has passed it.  On the CPU the work is done when the
    call returns."""

    def __init__(self, device: torch.device):
        self._event = None
        if device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()


def memory_peak(device: torch.device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def free(device: torch.device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
