"""The slowest analysis of the window, seconds on the host clock (with a few
units to a window, its tail)."""


def read(ctx):
    return max((u["unit_s"] for u in ctx["units"]), default=None)
