"""Fixtures of the benchmark's tests: a tiny copy of the benchmark (the
cells' files with every size cut so that a run fits the CPU), and the
`chip` marker of the tests that need a CUDA card."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

TINY_MODEL = dict(vocab_size=512, n_layers=2, d_model=128, n_heads=2,
                  d_ff=256, max_seq_len=256)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


def make_tiny_root(dest: Path) -> Path:
    """A copy of BENCHMARK.json and the benchmark's data files, every
    configuration at TINY_MODEL's sizes and every mix cut to match."""
    src = ROOT / "benchmark"
    for d in ("traffic", "limits", "configs", "metrics"):
        shutil.copytree(src / d, dest / "benchmark" / d)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg["run"].update(TINY_MODEL)
        cfg["vocab_published"] = 500
        path.write_text(json.dumps(cfg))
    for path in (dest / "benchmark" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        if mix["kind"] == "train":
            mix.update(rows=4, length=64, trace_seconds=0.5)
        else:
            mix["engine"].update(max_lanes=4, num_blocks=64,
                                 max_seq_len=256)
            mix.update(block_seconds=1.0, block=16, requests=256,
                       ramp_blocks=1, trace_seconds=0.5,
                       drain_seconds=120, check_tokens=32,
                       prompt_len=dict(median=48, sigma=0.5, min=16,
                                       max=112),
                       output_len=dict(median=8, sigma=0.7, min=2, max=32))
        path.write_text(json.dumps(mix))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {w["name"]: w for w in bench["workloads"]}
