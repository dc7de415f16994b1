#!/usr/bin/env python3
"""chip_smoke.py's mesh phases with a fault injected on every rank, to
show that their checks catch it.

    python3 scripts/mesh_controls.py [gpt] [llama]

Runs `chip_smoke._mesh_run` (gpt2-small on data2/fsdp2/tensor2, eight
ranks; llama-1b's widths at 2 layers on data2/tensor2, four ranks; the
same weights, batches and single-device run as the phases) with
`rank_bodies.train`'s controls: "no_grad_sync" (the gradients are not
summed over the row axes, so each data rank trains on its own rows)
and "no_update" (the optimizer never steps).  Prints one JSON line per
run with the readings the phases judge (the largest loss difference
and the largest relative update error against the single device, and
their limits) and the checks that failed, then the card's name and
power limit.  Exits 1 when a faulted run passes every check, 2 without
a card.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

RUNS = (("gpt", "no_grad_sync"), ("llama", "no_grad_sync"),
        ("llama", "no_update"))
READINGS = ("mesh", "ranks", "backend", "losses", "single_device_losses",
            "max_loss_diff", "loss_tolerance", "max_update_rel_err",
            "max_update_rel_err_at", "update_tolerance", "ranks_wall_s")


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_controls: no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build

    _build.build_all()
    families = sys.argv[1:] or ["gpt", "llama"]
    missed = []
    for family, control in RUNS:
        if family not in families:
            continue
        config, sizes, batches = chip_smoke.MESH_RUNS[family]()
        out = chip_smoke._mesh_run(family, config, sizes, batches,
                                   control=control)
        faults = chip_smoke._mesh_faults(out, config.n_layers)
        chip_smoke.emit("mesh_control", family=family, control=control,
                        caught=bool(faults), faults=faults,
                        **{k: out[k] for k in READINGS})
        if not faults:
            missed.append((family, control))
    print(chip_smoke.smi_line())
    if missed:
        print(f"mesh_controls: no check caught {missed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
