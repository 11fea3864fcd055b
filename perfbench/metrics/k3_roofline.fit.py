"""K3's share of its roofline over the traced refit, %: the launches of each
batch size (the program's counters, through graph replays, over the traced
units) times the bound of a launch at that batch (``roofline/k3.py``), over
the device seconds of K3 in the trace. The trace covers whole units."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.get("whole_units"):
        return None
    roof = ctx["roofline"]("k3")
    launches, seconds = ctx["kernel_time"](tr, roof.KERNELS)
    counts = tr["counters"]
    by_batch = {int(k.rsplit(".B", 1)[1]): n for k, n in counts.items() if k.startswith("launches.diag_chol_inv.B")}
    if not launches or seconds <= 0 or sum(by_batch.values()) != launches:
        return None
    bound = sum(n * ctx["peaks"].bound_s(*roof.cost(b)) for b, n in by_batch.items())
    return 100.0 * bound / seconds
