"""Model FLOPs utilisation of the Mellum serving cell: the forward FLOPs
of the real tokens computed in the traced part of the window (the
reference's `token_flops` and `prompt_flops`: each token's products,
its experts' included, attention over its context, at most the window
on a window layer, the head where a token is sampled; masked slots not
counted) over its seconds and 989 TFLOP/s.  A decode step computes the
previous output token; a prompt is counted where its first output token
arrives."""

from pathlib import Path

from benchmark import harness
from benchmark.drivers.serve import traced_span
from benchmark.flops import PEAK_FLOPS

ROOT = Path(__file__).resolve().parents[2]


def read(ctx):
    if ctx["kind"] != "serve" or "trace_end" not in ctx["marks"]:
        return None
    cfg = ctx["cfg"]
    ref = harness.reference({"config": {"run": cfg}, "root": ROOT})
    t0, t1 = traced_span(ctx)
    total = 0.0
    for r in ctx["records"]:
        p = len(r.prompt)
        for i, t in enumerate(r.times):
            if t0 <= t <= t1:
                total += (ref.prompt_flops(cfg, p) if i == 0
                          else ref.token_flops(cfg, p + i - 1, head=True))
    return 100 * total / (t1 - t0) / PEAK_FLOPS["bfloat16"]
