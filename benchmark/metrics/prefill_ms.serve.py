"""Host milliseconds per prefill dispatch of the engine (its stats():
each dispatch timed up to its tokens' copy to the host), over the
traced part of the window (the profiler recording)."""

from benchmark.drivers.serve import stats_delta

KIND = "prefill"


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    n = stats_delta(ctx, f"{KIND}_steps")
    if not n:
        return None
    return 1e3 * stats_delta(ctx, f"{KIND}_seconds") / n
