"""Where the port's pipelined train step spends its time, on one CUDA card.

    python3 scripts/profile_torch_pipeline.py            # 1F1B
    python3 scripts/profile_torch_pipeline.py gpipe

Builds chip_smoke.py's pipeline phase: gpt2-small with an untied head
(fp32 params, bf16 activations, random weights from a seed drawn on the
card) in four stage-chunks through ray_tpu_torch's PipelineTrainer on
chip_smoke's in-process runtime (every gang on this thread and this
card), 6 microbatches of 4 x 1024 a step, SGD.  Runs 1 warm-up step,
times 3 steps on the host clock (ending in a synchronise), then traces 2
more with torch.profiler: device time per step by kernel (the copies
across chunk boundaries appear as Memcpy DtoH / HtoD), the device's busy
share (device time over the untraced step), and the host ops by their
own CPU time (where the thread that drives every gang spends the step).
Prints one JSON line, then the card's nvidia-smi line.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

WARMUP, STEPS, TRACED = 1, 3, 2


def measure(schedule: str) -> dict:
    import chip_smoke as cs
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train import PipelineTrainer

    config = dataclasses.replace(gpt.CONFIGS["gpt2-small"],
                                 tie_embeddings=False)
    params = gpt.init_params(config, torch.Generator(
        device="cuda").manual_seed(13), device="cuda")
    data_fn = cs._pp_data(cs.PP_MICRO, cs.PP_MICRO_BATCH, cs.PP_SEQ,
                          config.vocab_size)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    clock = {}

    def fed(step):
        if step in (WARMUP, WARMUP + STEPS):
            torch.cuda.synchronize()
            clock[step] = time.perf_counter()
            if step == WARMUP + STEPS:
                prof.__enter__()
        return data_fn(step)

    tr = PipelineTrainer(cs._gpt_stage_fns(config, "cuda"),
                         cs._gpt_chunk_params(params, cs.PP_BOUNDS),
                         runtime=cs._PumpRuntime(), lr=cs.PP_LR,
                         n_microbatches=cs.PP_MICRO, schedule=schedule)
    try:
        tr.fit(fed, WARMUP + STEPS + TRACED)
        torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
        tr.shutdown()
    host_ms = (clock[WARMUP + STEPS] - clock[WARMUP]) / STEPS * 1e3
    events = prof.key_averages()
    device = [e for e in events if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in device) / TRACED / 1e3
    copies = {kind: sum(e.self_device_time_total for e in device
                        if kind in e.key) / TRACED / 1e3
              for kind in ("Memcpy DtoH", "Memcpy HtoD", "Memcpy DtoD")}
    flash_ms = sum(e.self_device_time_total for e in device
                   if "flash_" in e.key and "_kernel" in e.key) \
        / TRACED / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:15]
    host = sorted((e for e in events if e.device_type.name == "CPU"),
                  key=lambda e: -e.self_cpu_time_total)[:15]
    return {
        "config": "gpt2-small, tie_embeddings=False", "schedule": schedule,
        "chunks": [list(b) for b in cs.PP_BOUNDS],
        "n_microbatches": cs.PP_MICRO,
        "micro_batch": [cs.PP_MICRO_BATCH, cs.PP_SEQ], "steps": STEPS,
        "step_ms": host_ms, "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / host_ms,
        "copy_device_ms_per_step": copies,
        "flash_kernels_ms_per_step": flash_ms,
        "kernel_launches_per_step": sum(e.count for e in device) / TRACED,
        "top_kernels": [{"name": e.key[:90],
                         "ms_per_step": e.self_device_time_total / TRACED
                         / 1e3,
                         "calls_per_step": e.count / TRACED} for e in top],
        "top_host_ops": [{"name": e.key[:60],
                          "cpu_ms_per_step": e.self_cpu_time_total
                          / TRACED / 1e3,
                          "calls_per_step": e.count / TRACED}
                         for e in host],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_pipeline: needs a CUDA device", file=sys.stderr)
        return 1
    schedule = sys.argv[1] if len(sys.argv) > 1 else "1f1b"
    print(json.dumps(measure(schedule)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
