"""Where the port's decode step spends its time, on one CUDA card.

    python3 scripts/profile_torch_decode.py                  # gpt2-small
    python3 scripts/profile_torch_decode.py llama llama-1b

Builds ray_tpu_torch's InferenceEngine for a model family and config
(default gpt2-small; bf16, random weights from a seed drawn on the
card), fills all 32 lanes with a prompt of 512 tokens,
then times 16 decode steps two ways: the host clock per step (each step
ends in its one device->host transfer), and a torch.profiler trace of
another 16 steps giving the device time by kernel.  The device's busy
share is the device time per step over the untraced step: the profiler
about doubles a step's host time, so the traced window is no measure of
the step.  The decode kernel's two passes (split and merge) are also
summed on their own.  Runs greedy and with every lane sampling
(temperature > 0).  Prints one JSON line per mode, then the card's
nvidia-smi line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

LANES, CTX, STEPS = 32, 512, 16


def _fill(eng, temperature):
    """Admit one request per lane and run its whole prompt's prefill."""
    vocab = eng.config.vocab_size
    for i in range(LANES):
        eng.submit([(7 * i + j) % vocab for j in range(CTX)],
                   max_new_tokens=256, temperature=temperature, seed=i)
    for _ in range(-(-CTX // eng.prefill_chunk)):
        eng.step()


def measure(family: str, name: str, temperature: float) -> dict:
    import importlib

    from ray_tpu_torch.inference import InferenceEngine

    model = importlib.import_module(f"ray_tpu_torch.models.{family}")
    params = model.init_params(model.CONFIGS[name],
                               torch.Generator(device="cuda").manual_seed(0),
                               device="cuda")
    eng = InferenceEngine(family, name, params=params, device="cuda",
                          max_lanes=LANES, block_size=16, auto_start=False)
    _fill(eng, temperature)
    for _ in range(4):                                  # warm-up
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        eng.step()
    host_ms = (time.perf_counter() - t0) / STEPS * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            eng.step()
        traced_ms = (time.perf_counter() - t0) / STEPS * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in kernels)
    k4_us = sum(e.self_device_time_total for e in kernels
                if "paged_decode_" in e.key and "_kernel" in e.key)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    eng.shutdown()
    device_ms = device_us / STEPS / 1e3
    return {
        "config": name, "lanes": LANES, "ctx": CTX, "temperature": temperature,
        "steps": STEPS, "step_ms": host_ms, "traced_step_ms": traced_ms,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / host_ms,
        "paged_decode_ms_per_step": k4_us / STEPS / 1e3,
        "kernel_launches_per_step": sum(e.count for e in kernels) / STEPS,
        "top_kernels": [{"name": e.key[:80],
                         "ms_per_step": e.self_device_time_total / STEPS
                         / 1e3,
                         "calls_per_step": e.count / STEPS} for e in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_decode: needs a CUDA device", file=sys.stderr)
        return 1
    family, name = (sys.argv[1:3] if len(sys.argv) > 2
                    else ("gpt", "gpt2-small"))
    for temperature in (0.0, 0.8):
        print(json.dumps(measure(family, name, temperature)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
