"""The Mellum cell (mellum2-12b-a2.5b-instruct.serve-repo-longctx) at the
tiny sizes on the CPU: a run is `correct`; each fault planted in the
reference put in the program's place (the window left out, plain rope
on the full layers, the top-k weights not renormalised) and the fp8
control read a served gap above the cell's limit on the same sample; the
reference and the readers import nothing of the program; the readers of
the device trace on a trace made by hand."""

import json
import subprocess
import sys
import time

import pytest

from benchmark import harness
from benchmark.trace import Trace
from conftest import ROOT

CELL = "mellum2-12b-a2.5b-instruct.serve-repo-longctx"
SEED = 2 ** 33 + 91


@pytest.fixture(scope="module")
def sound(tiny_root):
    """One sound run of the tiny cell: (spec, its sample, its checks)."""
    spec = harness.load_cell(CELL, tiny_root)
    out = harness.driver("serve").run(spec, SEED, 1.0, False, "cpu",
                                      time.perf_counter())
    return spec, out["sample"], dict(out["checks"])


def test_tiny_cell_is_correct(tiny_root):
    from benchmark.run import run_cell

    result, checks = run_cell(CELL, 2 ** 32 + 77, 1.0, False, device="cpu",
                              root=tiny_root)
    assert result["correct"], checks
    assert set(result["metrics"]) == {"ttft_p95_ms", "tbt_p95_ms",
                                      "setup_s"}
    assert result["attempted"] and not result["failed"]


@pytest.mark.parametrize("wrong", ["fp8", "no_window", "plain_rope",
                                   "unnormalised"])
def test_faults_fail_the_served_gap(sound, wrong):
    spec, sample, checks = sound
    ref = harness.reference(spec)
    limit = spec["limits"]["served_gap"]
    assert checks["served_gap"] <= limit
    assert sum(len(served) for _, served in sample) >= \
        spec["traffic"]["check_tokens"]
    gaps = ref.served_gaps(spec["config"]["run"], SEED, sample, "cpu", wrong)
    assert max(gaps) > limit, (wrong, max(gaps), limit)


def test_reference_and_readers_import_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r); "
        "from pathlib import Path; from benchmark import harness; "
        "root = Path(%r); "
        "harness.reference({'config': {'run': {'reference': 'mellum'}}, "
        "'root': root}); "
        "[harness.reader(m, root) for m in ('mfu.mellum', "
        "'moe_roofline.mellum', 'window_decode_roofline.mellum', "
        "'device_idle.mellum')]; "
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        "{'ray_tpu_torch', 'ray_tpu', 'jax', 'jaxlib', 'flax'}); "
        "print(bad); sys.exit(1 if bad else 0)" % (str(ROOT), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


class _Record:
    def __init__(self, prompt, times, submitted=0.0):
        self.prompt, self.times, self.submitted = prompt, times, submitted


def _ctx(stats_open, stats_end):
    """A traced serve run's context over [10, 20] s of the host clock and
    of the trace: one request with a prompt of 3000 decoding 4 tokens in
    it, and the device intervals of one decode step."""
    cfg = json.loads((ROOT / "benchmark/configs/"
                      "mellum2-12b-a2.5b-instruct.json").read_text())["run"]
    mix = json.loads((ROOT / "benchmark/traffic/serve-repo-longctx.json")
                     .read_text())
    device = [(10.0 + 0.001 * i, 10.0005 + 0.001 * i,
               "void paged_decode_window_split_kernel<bf16, 128, 8>")
              for i in range(21)]
    device += [(11.0 + 0.001 * i, 11.0002 + 0.001 * i,
                "void paged_decode_window_merge_kernel<bf16>")
               for i in range(21)]
    device += [(12.0, 12.5, "cutlass::device_kernel<GroupProblemShape>"),
               (12.5, 12.6, "void at::cuda::detail::prepare_grouped_gemm_data")]
    marks = {"t0": (10.0, stats_open, {}),
             "trace_open": (10.0, stats_open, {}),
             "trace_end": (20.0, stats_end, {})}
    return {"kind": "serve", "cfg": cfg, "traffic": mix, "marks": marks,
            "records": [_Record(list(range(3000)),
                                [5.0, 12.0, 13.0, 14.0, 15.0])],
            "trace": Trace(device, [], 10.0, 20.0)}


def test_trace_readers_on_a_hand_made_trace():
    """Each reader's number from its formula: the windowed K4's bound over
    its device seconds, the expert products' bound from the counters'
    change over their seconds, the idle share; and nothing to read where
    the program has no such counters (a program that predates them)."""
    opened = {"moe_routed_pairs_prefill": 0, "moe_expert_loads_prefill": 0,
              "moe_routed_pairs_decode": 100, "moe_expert_loads_decode": 10}
    ended = {"moe_routed_pairs_prefill": 80_000,
             "moe_expert_loads_prefill": 1792,
             "moe_routed_pairs_decode": 100 + 28 * 256,
             "moe_expert_loads_decode": 10 + 28 * 60}
    ctx = _ctx(opened, ended)
    ref = harness.reference({"config": {"run": ctx["cfg"]}, "root": ROOT})
    read = {m: harness.reader(m, ROOT)(ctx) for m in (
        "window_decode_roofline.mellum", "moe_roofline.mellum",
        "device_idle.mellum", "mfu.mellum")}
    cfg = ctx["cfg"]
    bound = ref.window_decode_bound(cfg, [3000 + i for i in (1, 2, 3, 4)]
                                    + [1] * 28, 16)
    assert read["window_decode_roofline.mellum"] == pytest.approx(
        100 * bound / (21 * 0.0005 + 21 * 0.0002))
    moe = ref.expert_bound(cfg, 80_000, 1792) + ref.expert_bound(
        cfg, 28 * 256, 28 * 60)
    assert read["moe_roofline.mellum"] == pytest.approx(100 * moe / 0.6)
    assert 0 < read["moe_roofline.mellum"] < 100
    busy = 21 * 0.0005 + 21 * 0.0002 + 0.6
    assert read["device_idle.mellum"] == pytest.approx(100 * (1 - busy / 10))
    flops = sum(ref.token_flops(cfg, 3000 + i - 1, head=True)
                for i in (1, 2, 3, 4))
    assert read["mfu.mellum"] == pytest.approx(100 * flops / 10 / 989e12)
    old = _ctx({}, {})
    assert harness.reader("moe_roofline.mellum", ROOT)(old) is None


def test_window_counts_cap_attention_at_the_window():
    """The yardstick's counts: a token past the window pays the window on
    a window layer and its whole context on a full one; a prompt's FLOPs
    are the sum of its tokens' with one head."""
    cfg = json.loads((ROOT / "benchmark/configs/"
                      "mellum2-12b-a2.5b-instruct.json").read_text())["run"]
    ref = harness.reference({"config": {"run": cfg}, "root": ROOT})
    per_key = 4 * 32 * 128
    step = ref.token_flops(cfg, 5000, False) - ref.token_flops(cfg, 4999,
                                                                False)
    assert step == 7 * per_key
    assert ref.token_flops(cfg, 10, False) - ref.token_flops(cfg, 9, False) \
        == 28 * per_key
    n = 1500
    assert ref.prompt_flops(cfg, n) == pytest.approx(
        sum(ref.token_flops(cfg, i, False) for i in range(n))
        + 2 * 2304 * 98304, rel=1e-12)
