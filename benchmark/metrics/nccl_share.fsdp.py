"""Share of rank 0's traced window in which an NCCL kernel (the fsdp
gathers and reduce-scatters, the gradients' all-reduce) ran on its
card: the union of the intervals of kernels named "nccl" over the
window, overlapped by compute or not."""

NCCL = "nccl"


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "train" or ctx["chips"] < 2 or tr is None \
            or not tr.kernels(NCCL):
        return None
    return 100 * tr.seconds(NCCL) / tr.window_s
