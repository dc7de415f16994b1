"""Tokens trained per second per chip: every token of the window's whole
steps over the window's seconds (its end a synchronise) and the chips."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return ctx["steps"] * ctx["tokens_per_step"] / ctx["window_s"] \
        / ctx["chips"]
