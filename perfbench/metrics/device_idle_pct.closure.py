"""The device's idle share of the traced stretch, %: 1 - (the union of its
operations' intervals) / (the stretch's length), from the profiler's trace."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
