"""Whole runs of the tiny cells on the CPU: the result line's keys, a
cell added as data alone, the refusals (no card, forbidden modules)."""

import json
import math
import subprocess
import sys

import pytest

from benchmark import harness
from conftest import ROOT

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(root, workload, traced, seed=2 ** 33 + 5):
    from benchmark.run import run_cell
    return run_cell(workload, seed, 1.0, traced, device="cpu", root=root)


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(tiny_root, cells, traced, capsys):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for workload in cells:
        result, checks = _run(tiny_root, workload, traced)
        harness.emit(result, checks)
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert KEYS <= set(line) and list(line)[-1] == "checks"
        assert line["correct"] is True, line["checks"]
        want = {m["name"] for m in harness.cell_metrics(bench, workload,
                                                        traced)}
        got = set(line["metrics"])
        if traced:
            # No card: the readers of kernel shares find nothing.
            assert got <= want and got
            assert {"busy_s", "window_s"} <= set(line["device"])
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert got == want
        for m in line["metrics"].values():
            assert math.isfinite(m["value"]) and m["unit"]


def test_a_cell_added_as_data(tiny_root, tmp_path):
    """A new mix, configuration, limits and cell run with no edit of an
    existing file of the harness."""
    from conftest import make_tiny_root
    root = make_tiny_root(tmp_path / "copy")
    mixes = root / "benchmark" / "traffic"
    mix = json.loads((mixes / "serve-longprompt.json").read_text())
    mix.update(block=12,
               prompt_len=dict(median=20, sigma=0.3, min=8, max=40))
    (mixes / "serve-short.json").write_text(json.dumps(mix))
    cfg = json.loads((root / "benchmark/configs/gpt2-xl.json").read_text())
    cfg["name"] = "gpt2-xl-copy"
    (root / "benchmark/configs/gpt2-xl-copy.json").write_text(
        json.dumps(cfg))
    (root / "benchmark/limits/gpt2-xl-copy.serve-short.json").write_text(
        json.dumps({"served_gap": 1.0}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="gpt2-xl-copy",
                                 file="benchmark/configs/gpt2-xl-copy.json"))
    bench["workloads"].append({"name": "gpt2-xl-copy.serve-short",
                               "config": "gpt2-xl-copy",
                               "traffic": "serve-short", "chips": 1,
                               "why": "a cell added as data"})
    for m in bench["end_to_end"]:
        if "cerebras-gpt-6.7b.serve-longprompt" in m.get("workloads", []):
            m["workloads"].append("gpt2-xl-copy.serve-short")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = _run(root, "gpt2-xl-copy.serve-short", False)
    assert result["correct"] and "ttft_p95_ms" in result["metrics"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark/run.py"), "--workload",
         "gpt2-xl.train-1k", "--seed", str(2 ** 31 + 3), "--seconds", "1"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA card" in out.stderr


def test_forbidden_modules_by_whole_name():
    assert harness.forbidden_modules(
        ["ray_tpu_torch", "ray_tpu_torch.models", "numpy"]) == []
    assert harness.forbidden_modules(
        ["ray_tpu.util", "jaxlib.xla", "flax"]) == ["flax", "jaxlib",
                                                    "ray_tpu"]


def test_a_run_loads_no_forbidden_module(tiny_root):
    code = (
        "import sys; sys.path.insert(0, %r); sys.argv = ['x'];"
        "from pathlib import Path; import benchmark.run as R;"
        "from benchmark import harness;"
        "R.run_cell('cerebras-gpt-6.7b.serve-longprompt', 5, 1.0, True,"
        " device='cpu', root=Path(%r));"
        "R.run_cell('gpt2-xl.train-1k', 5, 0.5, False, device='cpu',"
        " root=Path(%r));"
        "print(harness.forbidden_modules())" % (str(ROOT), str(tiny_root),
                                                str(tiny_root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_arrival_clock_stands_while_the_profiler_starts(tiny_root,
                                                         monkeypatch):
    """A profiler that takes seconds to start or stop makes no request
    late, and the window still holds one block of the mix."""
    import time

    from benchmark import trace

    start, close = trace.TraceWindow.start, trace.TraceWindow.close

    def slow(fn):
        def wrapped(self):
            time.sleep(0.4)
            return fn(self)
        return wrapped

    monkeypatch.setattr(trace.TraceWindow, "start", slow(start))
    monkeypatch.setattr(trace.TraceWindow, "close", slow(close))
    result, _ = _run(tiny_root, "cerebras-gpt-6.7b.serve-longprompt", True)
    mix = json.loads((tiny_root / "benchmark/traffic/serve-longprompt.json")
                     .read_text())
    assert result["load"]["clock_stood_s"] >= 0.8
    assert result["load"]["late_s"] < 0.2, result["load"]
    assert result["attempted"] == mix["block"]


def test_window_is_one_block(tiny_root):
    from benchmark.run import run_cell
    with pytest.raises(harness.BenchError, match="one block"):
        run_cell("cerebras-gpt-6.7b.serve-longprompt", 3, 2.5, False,
                 device="cpu", root=tiny_root)
