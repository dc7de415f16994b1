"""Fixtures of the benchmark's tests: a tiny copy of the benchmark (the
cells' files with every size cut so that a run fits the CPU, each by its
family's reference and its mix's driver), and the `chip` marker of the
tests that need a CUDA card.

The tests' runs keep to `THREADS` of torch's CPU threads, and so do the
processes they start: the tiny serve cell's window is a second of wall
clock, and torch's default of a thread a core, on a host whose cores
other processes also use, stalls every operation on its slowest thread
(with six busy processes on eight cores, a window and its drain took
50 s at eight threads and 1.2 s at two)."""

import json
import os
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

THREADS = 2
os.environ["OMP_NUM_THREADS"] = str(THREADS)
torch.set_num_threads(THREADS)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


def make_tiny_root(dest: Path) -> Path:
    """A copy of BENCHMARK.json and the benchmark's data files and
    references, every configuration at its reference's `tiny_run` sizes
    and every mix cut by its driver's `tiny`."""
    from benchmark import harness

    src = ROOT / "benchmark"
    for d in ("traffic", "limits", "configs", "metrics", "references"):
        shutil.copytree(src / d, dest / "benchmark" / d)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        ref = harness.reference({"config": cfg, "root": dest})
        cfg["run"] = ref.tiny_run(cfg["run"])
        cfg["vocab_published"] = cfg["run"]["vocab_size"] - 12
        path.write_text(json.dumps(cfg))
    for path in (dest / "benchmark" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        path.write_text(json.dumps(harness.driver(mix["kind"]).tiny(mix)))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {w["name"]: w for w in bench["workloads"]}
