"""Share of rank 0's traced window in which an NCCL kernel ran on its
card and no other kernel, copy or fill did: the collectives' time that
no compute hides."""

NCCL = "nccl"


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "train" or ctx["chips"] < 2 or tr is None \
            or not tr.kernels(NCCL):
        return None
    return 100 * tr.alone_s(NCCL) / tr.window_s
