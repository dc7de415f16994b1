"""Where the port's V-trace learner update spends its time, on one CUDA card.

    python3 scripts/profile_torch_rl.py              # Nature-CNN, 64 x 16
    python3 scripts/profile_torch_rl.py cartpole     # MLP, 32 x 16

Builds ray_tpu_torch's `_VTraceLearner` with IMPALA's defaults (lr 6e-4,
grad clip 40) and fills it from a `RolloutWorker` on the card, as
chip_smoke.py's rl_learner phase does (SyntheticPixel-v0, 16 envs x 64
steps: 1,024 uint8 frames of 84x84x4) or its rl_podracer phase does
(CartPole-v1, 16 envs x 32 steps), in f32 with TF32 off (chip_smoke's
parity phases turn it off before these run).  Times the fragment's
sampling, then 3 warm-up and 10 timed updates on the host clock (each
ends in its metrics' host copy), then traces 5 more with torch.profiler
for the device time by kernel and by host op.  The device's busy share
is the device time per update over the untraced update.  Prints one
JSON line, then the card's nvidia-smi line.
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

WARMUP, STEPS, TRACED = 3, 10, 5
SETUPS = {"pixel": ("SyntheticPixel-v0", (84, 84, 4), 4, 64),
          "cartpole": ("CartPole-v1", 4, 2, 32)}


def measure(setup: str) -> dict:
    from ray_tpu_torch.rllib import IMPALAConfig, RolloutWorker
    from ray_tpu_torch.rllib.impala import _VTraceLearner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env, obs_dim, actions, length = SETUPS[setup]
    cfg = IMPALAConfig()
    worker = RolloutWorker(env, num_envs=16, rollout_fragment_length=length,
                           postprocess=False, seed=0, device="cuda")
    learner = _VTraceLearner(obs_dim, actions, cfg, cfg.model_hidden,
                             seed=0, device="cuda")
    worker.set_weights(learner.get_weights())
    worker.sample()
    t0 = time.perf_counter()
    batch, _ = worker.sample()
    sample_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(WARMUP):
        learner.update(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        learner.update(batch)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / STEPS * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACED):
            learner.update(batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in kernels) / TRACED / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type.name == "CPU"
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:12]
    return {
        "setup": setup, "env": env,
        "fragment": list(batch["obs"].shape),
        "fragment_bytes": int(batch["obs"].nbytes),
        "params": sum(p.numel() for p in learner.model.parameters()),
        "sample_ms_per_fragment": sample_ms,
        "update_ms": host_ms, "device_ms_per_update": device_ms,
        "device_busy_share": device_ms / host_ms,
        "kernel_launches_per_update": sum(e.count for e in kernels)
        / TRACED,
        "top_kernels": [{"name": e.key[:90],
                         "ms_per_update": e.self_device_time_total / TRACED
                         / 1e3,
                         "calls_per_update": e.count / TRACED} for e in top],
        "top_ops": [{"name": e.key[:60],
                     "device_ms_per_update": e.self_device_time_total
                     / TRACED / 1e3,
                     "calls_per_update": e.count / TRACED} for e in ops],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_rl: needs a CUDA device", file=sys.stderr)
        return 1
    setup = sys.argv[1] if len(sys.argv) > 1 else "pixel"
    print(json.dumps(measure(setup)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
