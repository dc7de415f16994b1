"""Share of the prefill dispatches' token slots that carry a real prompt
token: prompt tokens admitted without a cached prefix (the engine's
Observer counter inference_prefix_miss_tokens) over prefill dispatches
x max_lanes x prefill_chunk, over the traced part of the window."""

from benchmark.drivers.serve import counter_delta, stats_delta


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    n = stats_delta(ctx, "prefill_steps")
    if not n:
        return None
    eng = ctx["traffic"]["engine"]
    slots = n * eng["max_lanes"] * eng["prefill_chunk"]
    return 100 * counter_delta(ctx, "inference_prefix_miss_tokens") / slots
