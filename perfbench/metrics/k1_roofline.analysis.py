"""K1's share of its roofline in the traced stretch, %: the launches
of the kernel times its bound per launch at this cell's half-step batch
(``roofline/k1.py``, against the card's published peaks), over the
device seconds of its kernels in the trace. Every launch is counted at the
half-step batch; the few initial evaluations of a whole ensemble make the
share a hair low, never high."""


def read(ctx):
    if ctx["trace"] is None:
        return None
    roof = ctx["roofline"]("k1")
    launches, seconds = ctx["kernel_time"](ctx["trace"], roof.KERNELS)
    if not launches or seconds <= 0:
        return None
    return 100.0 * launches * ctx["peaks"].bound_s(*roof.cost(ctx["shapes"])) / seconds
