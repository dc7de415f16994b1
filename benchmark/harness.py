"""What every cell shares: finding a cell's files by name, the import
check, the metric readers, and the result's last line.

A cell of `BENCHMARK.json` names a configuration and a traffic mix.  The
configuration is `configs/<config>.json` (its `file` entry), the mix
`traffic/<traffic>.json`, whose `kind` names the driver
(`drivers/<kind>.py`), the limits of its correctness check
`limits/<workload>.json`, and each metric a reader
`metrics/<metric>.py` with `read(ctx) -> float | None`.  So a cell, a
mix, a configuration or a metric is added by adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

# Top-level module names that no process of the benchmark may load: the
# JAX stack and the JAX package the port was made from (whose name the
# port's name begins with, so names are compared whole).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ray_tpu", "chip_smoke")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a file missing, a
    metric with nothing to read in a cell that must report it)."""


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names in `modules` (default `sys.modules`) that are
    forbidden."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(n for n in names if n in FORBIDDEN_MODULES)


def check_imports() -> None:
    found = forbidden_modules()
    if found:
        raise BenchError(f"forbidden modules loaded: {', '.join(found)}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, its configuration, its traffic mix and its
    limits, each from its own file."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(root / "benchmark" / "traffic"
                        / f"{cell['traffic']}.json")
    limits = load_json(root / "benchmark" / "limits" / f"{workload}.json")
    return {"bench": bench, "cell": cell, "config": config,
            "traffic": traffic, "limits": limits}


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those whose `workloads` list it, or that have none."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if workload in m.get("workloads", [workload])]


def reader(name: str, root: Path = ROOT):
    """The `read` function of `benchmark/metrics/<name>.py`."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    if not path.exists():
        raise BenchError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def read_metrics(metrics: List[dict], ctx: dict, required: bool,
                 root: Path = ROOT) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something; a missing end-to-end metric (`required`) is an error."""
    out = {}
    for m in metrics:
        value = reader(m["name"], root)(ctx)
        if value is None or not math.isfinite(value):
            if required:
                raise BenchError(f"metric {m['name']} has no value")
            print(f"metric {m['name']}: nothing to read", file=sys.stderr)
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(checks: List[Tuple[str, float, float]]) -> bool:
    """Correct when every number compared is finite and at most its
    limit."""
    return all(math.isfinite(v) and v <= limit for _, v, limit in checks)


def emit(result: dict, checks: List[Tuple[str, float, float]]) -> None:
    """The numbers compared beside their limits, last on standard error
    and last in the result's line, which ends standard output."""
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    line = dict(result)
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in checks}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile: the smallest sample with at least q% of
    the samples at or below it."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]
