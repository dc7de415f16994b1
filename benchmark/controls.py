"""The controls of a cell's correctness check, run on the card:

    python3 benchmark/controls.py --workload gpt2-xl.train-1k \\
        --seeds 11,12,13 [--seconds 20]

For each seed, the program's readings as a run takes them, and the
control's: the plain reference put in the program's place and computed
one precision below the configuration's bf16 (every matrix product's
operands rounded to float8 e4m3), both held to the f32 reference by the
cell's numbers.  A training cell needs no window (the checked first
steps are the readings); a serving cell runs its mix for `--seconds`
and the control reads, at every served position of the same sample,
the gap of the token that the fp8 forward puts first.  One JSON line a
seed: {"seed", "program": {number: value}, "control": {number: value}}.
A limit is set between the program's largest and the control's
smallest reading.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def train_readings(spec, seed, device, control: bool) -> dict:
    """With `control`, also two faults planted in the reference put in
    the program's place: half of the batch left out (the mean over the
    rest), and a step that leaves the state unchanged (learning rate 0:
    its first gradients are the reference's, its losses those of the
    first weights)."""
    from benchmark.drivers import train

    setup = train.Setup(spec, seed, device)
    setup.close()
    ref = setup.reference(keep=True)
    out = {"program": dict(train.compare(setup.readings, ref)),
           "worst": train.worst_leaves(setup.readings, ref)}
    if control:
        for name, kw in (("control", {"precision": "fp8"}),
                         ("half_batch", {"rows": spec["traffic"]["rows"]
                                         // 2}),
                         ("unchanged", {"lr": 0.0})):
            other = setup.reference(judged=ref,
                                    kept_by=ref["first_grads"], **kw)
            judge = dict(ref, grad_diff_norms=other["grad_diff_norms"],
                         change_diff_norms=other["change_diff_norms"])
            out[name] = dict(train.compare(other, judge))
    return out


def serve_readings(spec, seed, device, seconds, control: bool) -> dict:
    from benchmark.drivers import serve
    from benchmark.references import gpt2

    run = serve.run(spec, seed, seconds, False, device, time.perf_counter())
    out = {"program": dict(run["checks"])}
    if control:
        low = gpt2.served_gaps(spec["config"]["run"], seed,
                               run["sample"], device, "fp8")
        out["control"] = {"served_gap": max(low)}
    return out


def readings(workload: str, seed: int, control: bool, device: str = "cuda",
             seconds: float = 20, root: Path = harness.ROOT) -> dict:
    """The program's numbers at `seed` and, with `control`, the
    control's."""
    spec = harness.load_cell(workload, root)
    if spec["traffic"]["kind"] == "train":
        return train_readings(spec, seed, device, control)
    return serve_readings(spec, seed, device, seconds, control)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3,
                   help="how many of the seeds, from the first, also read "
                        "the control")
    p.add_argument("--seconds", type=float, default=20)
    args = p.parse_args()
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        r = readings(args.workload, seed, i < args.control_seeds,
                     seconds=args.seconds)
        print(json.dumps({"seed": seed, **r}), flush=True)
    harness.check_imports()
    return 0


if __name__ == "__main__":
    sys.exit(main())
