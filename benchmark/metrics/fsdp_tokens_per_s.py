"""Tokens trained per second per chip over several cards: every token of
the window's whole steps over the window's seconds (rank 0's host
clock, from a synchronise of every rank to the next) and the chips."""


def read(ctx):
    if ctx["kind"] != "train" or ctx["chips"] < 2:
        return None
    return ctx["steps"] * ctx["tokens_per_step"] / ctx["window_s"] \
        / ctx["chips"]
