"""The windowed K4's share of its roofline in the Mellum serving cell:
the bound of its launches on the window layers in the traced window over
their device seconds (paged_decode_window_split_kernel and
paged_decode_window_merge_kernel).  Each decode step runs it once a
window layer over every lane; a lane decoding output token i of a
request with a prompt of P reads min(P + i, window) positions of its 4
kv heads, and a lane not decoding rides along with a context of 1.  The
lanes' contexts come from the tokens the clients received in the
traced window, the steps from the split kernel's launches over the
window layers (the reference's `window_decode_bound`)."""

from pathlib import Path

from benchmark import harness
from benchmark.drivers.serve import traced_span

ROOT = Path(__file__).resolve().parents[2]


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "serve" or tr is None:
        return None
    cfg, eng = ctx["cfg"], ctx["traffic"]["engine"]
    n_window = sum(k == "sliding_attention" for k in cfg["layer_types"])
    seconds = tr.seconds("paged_decode_window_split",
                         "paged_decode_window_merge")
    steps = len(tr.kernels("paged_decode_window_split")) / n_window
    if not seconds or not steps:
        return None
    ref = harness.reference({"config": {"run": cfg}, "root": ROOT})
    t0, t1 = traced_span(ctx)
    ctx_lens = [len(r.prompt) + i for r in ctx["records"]
                for i, t in enumerate(r.times) if i and t0 <= t <= t1]
    riders = max(0, round(steps * eng["max_lanes"]) - len(ctx_lens))
    bound = ref.window_decode_bound(cfg, ctx_lens + [1] * riders,
                                    eng["block_size"])
    return 100 * bound / seconds
