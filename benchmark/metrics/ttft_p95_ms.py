"""95th percentile (nearest rank) of submit -> first streamed token over
every request due in the window (one block of the mix); one that never
got its first token counts as infinitely late."""

from benchmark.harness import percentile


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    waits = [(r.times[0] - r.submitted) if r.times else float("inf")
             for r in ctx["window_records"]]
    p = percentile(waits, 95)
    return None if p is None else p * 1e3
