"""Share of the traced window in which no kernel, copy or fill ran on
the card in the Mellum serving cell: 1 - the union of the device
intervals over the window."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "serve" or tr is None:
        return None
    return 100 * (1 - tr.busy_s() / tr.window_s)
