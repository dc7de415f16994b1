"""The controls of a cell's correctness check, run on the card:

    python3 benchmark/controls.py --workload gpt2-xl.train-1k \\
        --seeds 11,12,13 [--seconds 20]

For each seed, the program's readings as a run takes them, and the
control's: the plain reference put in the program's place and computed
one precision below the configuration's bf16 (every matrix product's
operands rounded to float8 e4m3), both held to the f32 reference by the
cell's numbers.  A training cell needs no window (the checked first
steps are the readings) and also reads the faults planted in the
reference put in the program's place (half of the batch, a step that
leaves the state unchanged, and under a mesh the gradients' exchange
left out); a serving cell runs its mix for `--seconds` and the control
reads, at every served position of the same sample, the gap of the
token that the fp8 forward puts first.  One JSON line a seed: {"seed",
"program": {number: value}, "control": {number: value}, ...}.  A limit
is set between the program's largest and the control's smallest
reading.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def readings(workload: str, seed: int, control: bool, device: str = "cuda",
             seconds: float = 20, root: Path = harness.ROOT) -> dict:
    """The program's numbers at `seed` and, with `control`, the
    control's and the faults': the `readings` of the driver that the
    mix's `kind` names."""
    spec = harness.load_cell(workload, root)
    return harness.driver(spec["traffic"]["kind"]).readings(
        spec, seed, device, seconds, control)


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
