"""Run one cell of BENCHMARK.json once and print its result as the last
line of standard output:

    python3 benchmark/run.py --workload gpt2-xl.train-1k --seed 7 \\
        --seconds 51 --trace 0

`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics, read from a profiler trace of the first part of the
window.  The run exits non-zero, printing no result, without as many
CUDA cards as the cell asks for, or if the JAX stack or the JAX package
has been loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def device_info(count: int, peak: int, kind: str = None) -> dict:
    """The result's `device`: `kind` is the card's name as the driver's
    ranks read it (a driver over several ranks leaves the cards to
    them), else card 0's."""
    import torch
    return {"platform": "gpu",
            "kind": kind or torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": peak}


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", root: Path = harness.ROOT,
             t_start: float = None) -> tuple:
    """(result line without its checks, checks) of one run of the cell;
    `device` "cpu" runs it on the host (tests only: the result then
    names no card)."""
    spec = harness.load_cell(workload, root)
    chips = spec["cell"]["chips"]
    out = harness.driver(spec["traffic"]["kind"]).run(
        spec, seed, seconds, traced, device,
        T_START if t_start is None else t_start)
    harness.check_imports()
    limits = spec["limits"]
    checks = [(name, float(value), float(limits[name]))
              for name, value in out["checks"]]
    ctx = out["ctx"]
    metrics = harness.read_metrics(
        harness.cell_metrics(spec["bench"], workload, traced), ctx,
        required=not traced, root=root)
    result = {"correct": harness.judge(checks),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": (device_info(chips, out["memory_peak_bytes"],
                                     out.get("device_kind"))
                         if device == "cuda" else
                         {"platform": "cpu", "kind": "cpu", "count": 0,
                          "memory_peak_bytes": 0})}
    if "load" in out:
        result["load"] = out["load"]
    if traced:
        tr = ctx["trace"]
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.check_imports()
    import torch

    spec = harness.load_cell(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace))
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except harness.BenchError as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        sys.exit(3)
