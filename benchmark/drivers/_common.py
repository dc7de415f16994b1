"""What the drivers share: the program's configuration object built from a
configuration file, and a fence that waits for the device."""

from __future__ import annotations

import sys
import time

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def now() -> float:
    return time.perf_counter()


def log(what: str, since: float) -> None:
    """One line on standard error: a phase and its host seconds."""
    print(f"benchmark: {what} {now() - since:.3f} s", file=sys.stderr,
          flush=True)


def gpt_config(run: dict, **overrides):
    """The program's `GPTConfig` from a configuration file's `run`
    block (the fields of the port's GPT family, as run)."""
    from ray_tpu_torch.models.gpt import GPTConfig

    fields = {k: run[k] for k in ("vocab_size", "n_layers", "d_model",
                                  "n_heads", "d_ff", "max_seq_len")}
    return GPTConfig(dtype=DTYPES[run["dtype"]], **fields, **overrides)


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
