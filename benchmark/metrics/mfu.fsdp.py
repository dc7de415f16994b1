"""Model FLOPs utilisation of training under FSDP: the model FLOPs of the
whole steps finished in rank 0's traced part of the window (every matrix
product from its shapes and causal attention, forward and backward; no
recompute), over those seconds, the chips and 989 TFLOP/s (bf16,
dense)."""

from benchmark.flops import PEAK_FLOPS


def read(ctx):
    if ctx["kind"] != "train" or ctx["chips"] < 2 \
            or not ctx.get("traced_steps"):
        return None
    rate = ctx["traced_steps"] * ctx["flops_per_step"] / ctx["traced_s"]
    return 100 * rate / ctx["chips"] / PEAK_FLOPS["bfloat16"]
