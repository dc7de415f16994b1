"""Model FLOPs utilisation of serving: the forward FLOPs of the real
tokens computed in the traced part of the window (flops.token_flops:
each token's products, attention over its context, the head where a
token is sampled; masked slots not counted) over its seconds and 989
TFLOP/s.  A decode step computes the previous output token; a prompt
is counted where its first output token arrives."""

from benchmark.drivers.serve import traced_span
from benchmark.flops import PEAK_FLOPS, token_flops


def _prompt_flops(cfg, n):
    """Forward FLOPs of a prompt of n tokens, its last one sampled."""
    per = token_flops(cfg, 0, head=False)
    attn_step = token_flops(cfg, 1, head=False) - per
    return n * per + attn_step * n * (n - 1) / 2 \
        + token_flops(cfg, 0, head=True) - per


def read(ctx):
    if ctx["kind"] != "serve" or "trace_end" not in ctx["marks"]:
        return None
    cfg = ctx["cfg"]
    t0, t1 = traced_span(ctx)
    total = 0.0
    for r in ctx["records"]:
        p = len(r.prompt)
        for i, t in enumerate(r.times):
            if not t0 <= t <= t1:
                continue
            total += (_prompt_flops(cfg, p) if i == 0
                      else token_flops(cfg, p + i - 1, head=True))
    return 100 * total / (t1 - t0) / PEAK_FLOPS["bfloat16"]
