"""The controls on the card, at each cell's own size: the program's
numbers within their limits, the control's (the reference in fp8 put in
the program's place) and a training cell's half-batch fault beyond at
least one.  Marked `chip`; without a CUDA card they skip.  Run them on
the card with `python -m pytest benchmark/tests -m chip`."""

import json

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 101


def _fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] > v for k, v in limits.items())


@pytest.mark.chip
@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH["workloads"]])
def test_controls_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import controls

    limits = json.loads(
        (ROOT / "benchmark" / "limits" / f"{workload}.json").read_text())
    got = controls.readings(workload, SEED, True,
                            seconds=BENCH["run_seconds"])
    assert not _fails(got["program"], limits), got
    assert _fails(got["control"], limits), got
    if "half_batch" in got:
        assert _fails(got["half_batch"], limits), got
