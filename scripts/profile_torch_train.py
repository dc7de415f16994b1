"""Where the port's train step spends its time, on one CUDA card.

    python3 scripts/profile_torch_train.py                   # gpt2-small
    python3 scripts/profile_torch_train.py llama llama-1b    # 4 x 2048
    python3 scripts/profile_torch_train.py gpt gpt2-small 8  # 8 experts

Builds ray_tpu_torch's train step for a model family and config
(default gpt2-small; bf16 activations, fp32 params, random weights from
a seed drawn on the card, AdamW) on one repeated batch of random tokens
(gpt2-small 24 x 1024, as bench.py drives the reference; llama-1b
4 x 2048, as chip_smoke.py's train_llama phase; with a third argument,
that many Switch experts per layer on 8 x 1024, as chip_smoke.py's
train_moe phase); runs 2
warm-up steps, times 4 steps on the host clock (ending in a
synchronise), then traces 3 more with torch.profiler for the device
time by kernel.  The device's busy share is the device time per step
over the untraced step.  The flash-attention kernels (K1-K3) are also
summed on their own.  Prints one JSON line, then the card's nvidia-smi
line.
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

WARMUP, STEPS, TRACED = 2, 4, 3
# (batch, seq) per config; the default takes the config's max_seq_len.
SHAPES = {"gpt2-small": (24, 1024), "llama-1b": (4, 2048)}


def measure(family: str, name: str, experts: int = 0) -> dict:
    import dataclasses
    import importlib

    from ray_tpu_torch.models._functional import adamw

    model = importlib.import_module(f"ray_tpu_torch.models.{family}")
    config = model.CONFIGS[name]
    n_seqs, seq = SHAPES.get(name, (4, config.max_seq_len))
    if experts:
        config = dataclasses.replace(config, n_experts=experts)
        n_seqs, seq = 8, 1024
    init_state, train_step = model.make_train_step(config, adamw(1e-4),
                                                   device="cuda")
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, config.vocab_size, (n_seqs, seq),
                           generator=torch.Generator().manual_seed(1)).cuda()
    batch = {"tokens": tokens}
    for _ in range(WARMUP):
        state, _ = train_step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, _ = train_step(state, batch)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / STEPS * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACED):
            state, _ = train_step(state, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in kernels) / TRACED / 1e3
    flash_ms = sum(e.self_device_time_total for e in kernels
                   if "flash_" in e.key and "_kernel" in e.key) / TRACED / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    # The host ops that launched them, by the device time of their own
    # launches (aten names say which line of the model a kernel is).
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type.name == "CPU"
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:15]
    return {
        "config": name, "n_experts": experts, "batch": n_seqs, "seq": seq,
        "steps": STEPS,
        "step_ms": host_ms, "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / host_ms,
        "flash_kernels_ms_per_step": flash_ms,
        "kernel_launches_per_step": sum(e.count for e in kernels) / TRACED,
        "top_kernels": [{"name": e.key[:90],
                         "ms_per_step": e.self_device_time_total / TRACED
                         / 1e3,
                         "calls_per_step": e.count / TRACED} for e in top],
        "top_ops": [{"name": e.key[:60],
                     "device_ms_per_step": e.self_device_time_total
                     / TRACED / 1e3,
                     "calls_per_step": e.count / TRACED} for e in ops],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA device", file=sys.stderr)
        return 1
    family, name = (sys.argv[1:3] if len(sys.argv) > 2
                    else ("gpt", "gpt2-small"))
    experts = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    print(json.dumps(measure(family, name, experts)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
