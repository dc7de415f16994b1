"""Share of rank 0's traced window in which no kernel, copy or fill ran
on its card under FSDP: 1 - the union of the device intervals over the
window."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "train" or ctx["chips"] < 2 or tr is None:
        return None
    return 100 * (1 - tr.busy_s() / tr.window_s)
