"""K4's share of its roofline in serving: the bound of its launches in
the traced window over their device seconds (paged_decode_split_kernel
and paged_decode_merge_kernel).  Each decode step runs K4 once a layer
over every lane; a lane decoding output token i of a request with a
prompt of P reads a context of P + i positions, and a lane not decoding
rides along with a context of 1.  The lanes' contexts come from the
tokens the clients received in the traced window, the steps from the
split kernel's launches over the layers (flops.decode_bound)."""

from benchmark.drivers.serve import traced_span
from benchmark.flops import decode_bound


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "serve" or tr is None:
        return None
    cfg, eng = ctx["cfg"], ctx["traffic"]["engine"]
    seconds = tr.seconds("paged_decode_split", "paged_decode_merge")
    steps = len(tr.kernels("paged_decode_split")) / cfg["n_layers"]
    if not seconds or not steps:
        return None
    t0, t1 = traced_span(ctx)
    ctx_lens = [len(r.prompt) + i for r in ctx["records"]
                for i, t in enumerate(r.times) if i and t0 <= t <= t1]
    riders = max(0, round(steps * eng["max_lanes"]) - len(ctx_lens))
    heads = cfg["n_heads"]
    bound = cfg["n_layers"] * decode_bound(
        ctx_lens + [1] * riders, heads, heads, cfg["d_model"] // heads,
        eng["block_size"], cfg["dtype"])
    return 100 * bound / seconds
