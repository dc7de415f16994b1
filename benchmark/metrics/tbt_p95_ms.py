"""95th percentile (nearest rank) of every gap between consecutive
streamed tokens of a request, over the gaps that end in the window."""

from benchmark.harness import percentile


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    t0, t1 = ctx["t0"], ctx["t1"]
    gaps = [b - a for r in ctx["records"]
            for a, b in zip(r.times, r.times[1:]) if t0 <= b <= t1]
    p = percentile(gaps, 95)
    return None if p is None else p * 1e3
