"""Time K1-K4 of one checkout's ray_tpu_torch on one CUDA card.

    python3 scripts/time_kernels.py [TREE] [--split-lens 64,128,256]

TREE is a checkout of this repo (default: the one this script is in),
for example a parent commit unpacked with `git archive`.  Its
ray_tpu_torch is imported and its kernels built from its sources; the
inputs, bounds and timer are this script's chip_smoke.py's, so that two
checkouts timed in one call compare on one measure.  Each kernel runs
where its main path runs it: K1-K3 at the train shape (B 24, L 1024, 12
heads of 64, causal, bf16), K4 at the gpt2-small decode shape (32 lanes,
12 heads of 64, block 16, ragged contexts up to 1024, bf16), on the
inputs chip_smoke.py draws for those cases.  Each is timed with the
device spin (`ms`, the device's time) and without it (`ms_with_launch`,
the host's enqueue included where it is the longer).  With --split-lens,
K4 is also checked and timed at each of those split lengths, set in
turn as the checkout's `ops.attention.DECODE_SPLIT_LEN`.  Prints one
JSON line, then the card's nvidia-smi line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    """This checkout's chip_smoke.py, whatever TREE holds."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=str(REPO))
    ap.add_argument("--split-lens", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    C = _chip_smoke()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as A

    _build.build_all()
    out = {"tree": args.tree}

    def both(fn, reps):
        return dict(ms=C._time_ms(fn, reps), ms_with_launch=C._time_ms(
            fn, reps, spin=False))

    c = C._decode_case(torch.Generator().manual_seed(0), b=32, kh=12,
                       q_per_kv=1, d=64, bs=16, max_ctx=1024,
                       dtype=torch.bfloat16)
    plain = A.paged_decode_attention_plain(**c).float()
    atol, rtol = C.TOLERANCE[torch.bfloat16]

    def k4():
        err = (A.paged_decode_attention(**c).float() - plain).abs()
        C.check(bool((err <= atol + rtol * plain.abs()).all()),
                "K4 disagrees with its plain version")
        return both(lambda: A.paged_decode_attention(**c), 40)

    out["K4"] = dict(k4(), bound_ms=C._decode_bound(c)[0])
    default = getattr(A, "DECODE_SPLIT_LEN", None)
    for n in (int(x) for x in args.split_lens.split(",") if x):
        A.DECODE_SPLIT_LEN = n
        out.setdefault("K4_by_split_len", {})[n] = k4()
    if default is not None:
        A.DECODE_SPLIT_LEN = default

    f = C.FLASH_CASES["train-bf16"]
    gen = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(f["b"], f["lq"], f["h"], f["d"],
                               generator=gen).to(f["dtype"]).cuda()
                   for _ in range(4))
    scale = f["d"] ** -0.5
    o, lse = A.flash_forward(q, k, v, True, scale)
    _, delta = A.flash_dq(q, k, v, o, lse, do, True, scale)
    bounds = C._flash_bounds(f)
    for name, fn in (
            ("K1", lambda: A.flash_forward(q, k, v, True, scale)),
            ("K2", lambda: A.flash_dq(q, k, v, o, lse, do, True, scale)),
            ("K3", lambda: A.flash_dkv(q, k, v, do, lse, delta, True,
                                       scale))):
        out[name] = dict(both(fn, 20), bound_ms=bounds[name][0])
    print(json.dumps(out), flush=True)
    print(C.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
